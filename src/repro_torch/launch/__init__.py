"""Launchers of the port.  Counterpart of ``src/repro/launch/``, every module
ported: ``serve`` (one device or a mesh), ``train`` (one device), ``mesh``
(local and production meshes, the H100's figures), ``specs``, ``dryrun``
(one rank's step counted on ``meta``), ``roofline``, ``pricing`` and
``report``."""
