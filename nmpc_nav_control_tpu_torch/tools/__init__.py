"""Measurement tools of the port: ``phase_probe`` (the controller tick by
phase) and ``node_probe`` (the navigation tick by phase), the counterparts
of the JAX package's ``tools/phase_probe.py`` and ``tools/node_probe.py``.
"""
