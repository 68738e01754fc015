// Single-query attention tile walk on Hopper (sm_90a): the pieces a decode
// kernel needs once it has staged a tile of K and V rows in shared memory.
//
// One block of kThreads threads owns one (sequence, kv head, chunk of GC
// query heads).  The block's threads form NG lane groups of L lanes.  A
// group walks its own rows of every staged tile (rows gi, gi + NG, ...) and
// keeps its own online-softmax state, so no barrier separates the scores,
// the softmax and the weighted sum of a tile:
//
//   - each lane holds E of the hd query values of all GC heads in
//     registers (already scaled by 1/sqrt(hd) * log2(e), so the softmax is
//     taken with exp2), and E accumulator values of each head;
//   - a lane reads its E values of a K row once from shared memory and uses
//     each for GC heads; the dot products are summed over the group's L
//     lanes with xor shuffles, which leave the same bits in every lane;
//   - the running maximum m, the sum l and acc stay in registers in fp32;
//     acc is rescaled only when a tile raises the maximum;
//   - an invalid row is never read (its K and V may hold anything, inf and
//     NaN included) and adds exactly nothing.
//
// Rows are staged in their stored type (fp32 or bf16) as 16-byte chunks.
// A lane owns chunks k, k + L, ... of a row, so the L lanes of a group read
// L neighbouring chunks; Cfg::swz places chunk c of row r so that the 8
// lanes of each quarter warp hit 8 different 16-byte bank groups.
//
// ring_walk() stages the tiles with 16-byte cp.async into a ring of kStages
// in the stored type, so the next kStages - 1 tiles are in flight while one
// is folded.  Where row p lives is the caller's: a row map gives, for each
// p, one int that says where the row is (a pos, a pool block id) or that it
// is empty (< 0), and the row's offset from that int.  That int arrives by
// 4-byte cp.async one ring ahead of its row, so an empty row (or one past
// the last) is never fetched, and inf or NaN in it is never read.
//
// block_combine() merges the NG group states of a block into one (m, l, acc)
// per head; out = acc / max(l, 1e-30), so a head with no valid row
// (m = -1e30, l = 0, acc = 0) gives exactly 0.
//
// Users: the dense ring-cache decode kernel (decode_attention.cu), whose row
// p is slot p of the sequence's cache, empty where pos[p] < 0, and the paged
// decode kernel (paged_attention.cu), whose row p is slot p % bs of pool
// block tables[b, p / bs], empty from ctx_len on.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper_mma.cuh"
#include "scalar.cuh"

namespace repro {
namespace dtile {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;  // depth of the K/V ring
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr size_t kMaxSmem = 232448;  // bytes one block may use on sm_90

// Rows (tokens) per tile: 8 KB of bf16 K rows from hd 32 up, 128 rows below.
constexpr int tile_rows(int hd) { return hd >= 32 ? 4096 / hd : 128; }

// A 16-byte chunk of stored values unpacked to fp32.
template <typename T>
struct Chunk;

template <>
struct Chunk<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& raw, float* dst) {
    dst[0] = __uint_as_float(raw.x);
    dst[1] = __uint_as_float(raw.y);
    dst[2] = __uint_as_float(raw.z);
    dst[3] = __uint_as_float(raw.w);
  }
};

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& raw, float* dst) {
    const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // a bf16 is the upper half of the fp32 of the same value
      dst[2 * i] = __uint_as_float(w[i] << 16);
      dst[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <typename T, int HD, int GC>
struct Cfg {
  static constexpr int VN = Chunk<T>::N;              // values per 16-byte chunk
  static constexpr int NCH = HD / VN;                 // chunks per row
  static constexpr int E_MAX = GC <= 4 ? 16 : 8;      // q and acc: 2 * GC * E registers
  static constexpr int E = E_MAX < HD ? E_MAX : HD;   // values of a row a lane owns
  static constexpr int CPL = E / VN;                  // chunks a lane owns
  static constexpr int L = NCH / CPL;                 // lanes per group
  static constexpr int NG = kThreads / L;             // groups per block
  static constexpr int TILE = tile_rows(HD);          // rows per tile
  static constexpr int RPG = TILE / NG;               // rows of a tile per group
  static constexpr int TILE_CH = TILE * NCH;          // chunks of one tensor per tile
  static constexpr int CPT = TILE_CH / kThreads;      // chunks a thread stages per tensor
  static_assert(CPL >= 1 && L >= 1 && L <= 32, "lane groups must fit a warp");
  static_assert(RPG >= 1 && TILE % NG == 0, "every group needs whole rows of a tile");
  static_assert(CPT >= 1 && TILE_CH % kThreads == 0, "the threads stage whole tiles");

  // Where chunk c of row r lies, in chunks from the tile's start.  From 8
  // chunks a row (128 bytes) up, the low 3 bits of c are xor-ed with r * L;
  // below, rows share a 128-byte line and the line's index (mod CPL), times
  // L, is xor-ed in.  Either way a row keeps its own chunks.
  __device__ static int swz(int r, int c) {
    if constexpr (NCH >= 8) {
      return r * NCH + (c ^ ((r * L) & 7));
    } else {
      const int p = r * NCH + c;
      return p ^ (((p >> 3) % CPL) * L);
    }
  }

  // Floats of shared memory block_combine() needs.
  static constexpr int RED_FLOATS = 2 * GC * NG + 8 + NG * GC * HD;
};

template <typename T, int HD, int GC>
struct GroupState {
  using C = Cfg<T, HD, GC>;
  float q[GC][C::E];
  float acc[GC][C::E];
  float m[GC];
  float l[GC];

  // q_rows: the first of this block's heads, (GC, HD) in the stored type;
  // heads at or past n_here read as 0 and are never written.
  __device__ void init(const T* q_rows, int n_here, float scale, int k) {
    const float s = scale * kLog2e;
#pragma unroll
    for (int h = 0; h < GC; ++h) {
#pragma unroll
      for (int j = 0; j < C::CPL; ++j) {
        float v[C::VN];
        if (h < n_here) {
          Chunk<T>::unpack(
              *reinterpret_cast<const uint4*>(q_rows + h * HD + (j * C::L + k) * C::VN), v);
        } else {
#pragma unroll
          for (int e = 0; e < C::VN; ++e) v[e] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < C::VN; ++e) {
          q[h][j * C::VN + e] = v[e] * s;
          acc[h][j * C::VN + e] = 0.f;
        }
      }
      m[h] = kNegInf;
      l[h] = 0.f;
    }
  }

  // Fold the group's rows of one staged tile into the state.  kb, vb: the
  // tile's K and V chunks laid out by Cfg::swz; valid(r): whether row r of
  // the tile takes part (the same answer for every lane of a group).  Every
  // thread of the block calls it (the shuffles span the whole warp).
  template <class Valid>
  __device__ __forceinline__ void fold(const uint4* kb, const uint4* vb, int gi, int k,
                                       Valid valid) {
    float sc[C::RPG][GC];
    bool ok[C::RPG];
#pragma unroll
    for (int i = 0; i < C::RPG; ++i) {
      const int r = gi + i * C::NG;
      ok[i] = valid(r);
#pragma unroll
      for (int h = 0; h < GC; ++h) sc[i][h] = 0.f;
      if (ok[i]) {
#pragma unroll
        for (int j = 0; j < C::CPL; ++j) {
          float kf[C::VN];
          Chunk<T>::unpack(kb[C::swz(r, j * C::L + k)], kf);
#pragma unroll
          for (int e = 0; e < C::VN; ++e)
#pragma unroll
            for (int h = 0; h < GC; ++h) sc[i][h] = fmaf(q[h][j * C::VN + e], kf[e], sc[i][h]);
        }
      }
    }
#pragma unroll
    for (int o = C::L / 2; o > 0; o >>= 1)
#pragma unroll
      for (int i = 0; i < C::RPG; ++i)
#pragma unroll
        for (int h = 0; h < GC; ++h) sc[i][h] += __shfl_xor_sync(0xffffffffu, sc[i][h], o);

#pragma unroll
    for (int h = 0; h < GC; ++h) {
      float mx = kNegInf;
#pragma unroll
      for (int i = 0; i < C::RPG; ++i)
        if (ok[i]) mx = fmaxf(mx, sc[i][h]);
      if (mx > m[h]) {
        const float a = exp2f(m[h] - mx);
        m[h] = mx;
        l[h] *= a;
#pragma unroll
        for (int e = 0; e < C::E; ++e) acc[h][e] *= a;
      }
    }
#pragma unroll
    for (int i = 0; i < C::RPG; ++i) {
      if (!ok[i]) continue;
      const int r = gi + i * C::NG;
      float p[GC];
#pragma unroll
      for (int h = 0; h < GC; ++h) {
        p[h] = exp2f(sc[i][h] - m[h]);
        l[h] += p[h];
      }
#pragma unroll
      for (int j = 0; j < C::CPL; ++j) {
        float vf[C::VN];
        Chunk<T>::unpack(vb[C::swz(r, j * C::L + k)], vf);
#pragma unroll
        for (int e = 0; e < C::VN; ++e)
#pragma unroll
          for (int h = 0; h < GC; ++h)
            acc[h][j * C::VN + e] = fmaf(p[h], vf[e], acc[h][j * C::VN + e]);
      }
    }
  }

  // Merge the block's NG group states.  red: C::RED_FLOATS floats of shared
  // memory that no copy or thread still uses.  Calls emit(h, d, acc, l)
  // once for each head h < GC and column d < HD, acc and l scaled to the
  // block's maximum.  Every thread of the block calls it.
  template <class Emit>
  __device__ __forceinline__ void block_combine(float* red, int gi, int k, Emit emit) const {
    float* red_m = red;                      // (GC, NG)
    float* red_l = red_m + GC * C::NG;       // (GC, NG)
    float* red_big = red_l + GC * C::NG;     // (GC), padded to 8
    float* red_acc = red_big + 8;            // (NG, GC * HD)
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    if (k == 0) {
#pragma unroll
      for (int h = 0; h < GC; ++h) red_m[h * C::NG + gi] = m[h];
    }
    __syncthreads();
    for (int h = warp; h < GC; h += kWarps) {
      float x = kNegInf;
      for (int i = lane; i < C::NG; i += 32) x = fmaxf(x, red_m[h * C::NG + i]);
      x = warp_max(x);
      if (lane == 0) red_big[h] = x;
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < GC; ++h) {
      const float w = exp2f(m[h] - red_big[h]);
      if (k == 0) red_l[h * C::NG + gi] = l[h] * w;
      float* dst = red_acc + (size_t)gi * GC * HD + h * HD;
#pragma unroll
      for (int j = 0; j < C::CPL; ++j)
#pragma unroll
        for (int e = 0; e < C::VN; ++e)
          dst[(j * C::L + k) * C::VN + e] = acc[h][j * C::VN + e] * w;
    }
    __syncthreads();
    for (int idx = tid; idx < GC * HD; idx += kThreads) {
      const int h = idx / HD, d = idx - h * HD;
      float a = 0.f, lsum = 0.f;
      for (int i = 0; i < C::NG; ++i) {
        a += red_acc[(size_t)i * GC * HD + idx];
        lsum += red_l[h * C::NG + i];
      }
      emit(h, d, a, lsum);
    }
  }
};

constexpr int kIdSlots = 2 * kStages - 1;  // a tile's row ids land kStages - 1 groups early

// Bytes of shared memory ring_walk() and then block_combine() use.
template <typename T, int HD, int GC>
constexpr size_t ring_smem_bytes() {
  using C = Cfg<T, HD, GC>;
  constexpr size_t ring = 2 * kStages * C::TILE_CH * 16 + kIdSlots * C::TILE * sizeof(int);
  constexpr size_t red = C::RED_FLOATS * sizeof(float);
  return ring > red ? ring : red;
}

// Fold rows 0 .. n_rows - 1 of one (sequence, kv head) into st, tile by
// tile, through a cp.async ring in smem (ring_smem_bytes() bytes, 16-byte
// aligned).  Rows is the row map:
//   const int* id(int p)       the int that says where row p lives; < 0: empty
//   size_t at(int p, int id)   the offset of row p, in elements, from k and v
// k, v: this kv head's first value in the caches (row offsets are added).
// st is initialised here from q_rows (see GroupState::init) while the first
// tiles' ids are in flight.  Every thread of the block calls it; on return
// every copy has landed and smem is free for block_combine().
template <typename T, int HD, int GC, class Rows>
__device__ __forceinline__ void ring_walk(GroupState<T, HD, GC>& st, unsigned char* smem,
                                          const T* __restrict__ k, const T* __restrict__ v,
                                          int n_rows, const Rows& rows, const T* q_rows,
                                          int n_here, float scale, int gi, int lane) {
  using C = Cfg<T, HD, GC>;
  constexpr int TILE = C::TILE, TILE_CH = C::TILE_CH, NCH = C::NCH, VN = C::VN;
  uint4* kbuf = reinterpret_cast<uint4*>(smem);                 // (kStages, TILE_CH)
  uint4* vbuf = kbuf + kStages * TILE_CH;                       // (kStages, TILE_CH)
  int* id_s = reinterpret_cast<int*>(vbuf + kStages * TILE_CH);  // (kIdSlots, TILE)
  const int tid = threadIdx.x;
  const int n_tiles = n_rows > 0 ? (n_rows + TILE - 1) / TILE : 0;

  auto load_ids = [&](int t) {
    if (t >= n_tiles) return;
    int* dst = id_s + (t % kIdSlots) * TILE;
    for (int r = tid; r < TILE; r += kThreads) {
      const int p = t * TILE + r;
      if (p < n_rows)
        mma::cp_async4(dst + r, rows.id(p));
      else
        dst[r] = -1;
    }
  };
  auto load_kv = [&](int t) {
    if (t >= n_tiles) return;
    const int* ids = id_s + (t % kIdSlots) * TILE;
    uint4* kd = kbuf + (t % kStages) * TILE_CH;
    uint4* vd = vbuf + (t % kStages) * TILE_CH;
#pragma unroll
    for (int m = 0; m < C::CPT; ++m) {
      const int i = tid + m * kThreads;
      const int r = i / NCH, c = i - r * NCH;
      const int id = ids[r];
      if (id >= 0) {
        const size_t off = rows.at(t * TILE + r, id) + (size_t)c * VN;
        const int to = C::swz(r, c);
        mma::cp_async16(kd + to, k + off);
        mma::cp_async16(vd + to, v + off);
      }
    }
  };

  // Group u of copies holds the rows of tile u and the ids of tile
  // u + kStages - 1, which load_kv needs right after group u has landed.
  // The queries load while the first tiles' ids are in flight.
  for (int t = 0; t < kStages - 1; ++t) load_ids(t);
  mma::cp_async_commit();
  st.init(q_rows, n_here, scale, lane);
  mma::cp_async_wait<0>();
  __syncthreads();
  for (int t = 0; t < kStages - 1; ++t) {
    load_kv(t);
    load_ids(t + kStages - 1);
    mma::cp_async_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    mma::cp_async_wait<kStages - 2>();  // group t has landed
    __syncthreads();                    // ... for every thread, and tile t - 1 is folded
    load_kv(t + kStages - 1);
    load_ids(t + 2 * kStages - 2);
    mma::cp_async_commit();
    const int* ids = id_s + (t % kIdSlots) * TILE;
    st.fold(kbuf + (t % kStages) * TILE_CH, vbuf + (t % kStages) * TILE_CH, gi, lane,
            [&](int r) { return ids[r] >= 0; });
  }
  mma::cp_async_wait<0>();
  __syncthreads();  // the ring is free for block_combine
}

}  // namespace dtile
}  // namespace repro
