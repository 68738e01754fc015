"""Launchers of the port.  Counterpart of ``src/repro/launch/``: ``serve`` and
``train`` (single device) are ported; the mesh, dry-run, roofline, report and
pricing launchers come with the distributed slice."""
