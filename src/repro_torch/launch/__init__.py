"""Launchers of the port.  Counterpart of ``src/repro/launch/``: ``serve`` (one
device or a mesh), ``train`` (one device) and ``mesh`` are ported; the
dry-run, roofline, report and pricing tooling comes with the launch-tooling
slice."""
