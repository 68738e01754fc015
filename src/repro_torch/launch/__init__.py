"""Launchers of the port.  Counterpart of ``src/repro/launch/``: ``serve``
(single device) is ported; the mesh, dry-run, roofline, report, pricing and
train launchers come with the distributed and training slices."""
