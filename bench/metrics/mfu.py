"""The window's share of the card's bf16 peak: the FLOPs the probes
answered in the window need (``harness.yardstick``: each one forward over
its own unpadded prompt, counted after the window from the rounds the loop
captured), over the window's seconds times 989 TFLOP/s."""


def read(run: dict):
    if not run["flops"]:
        return None
    return 100.0 * run["flops"] / (run["window_s"] * run["peak_flops"])
