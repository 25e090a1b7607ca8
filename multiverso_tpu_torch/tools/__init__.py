"""The port's own copies of the repo's operator CLIs, each the repo's
``tools/<name>.py`` over the port's ops plane, so they run where JAX is
not installed:

- ``mvplan``, the placement advisor the capacity worker runs over a
  scraped fleet;
- ``latdoctor``, the per-stage latency table and the dominant stage of
  each rank;
- ``mvaudit``, the fleet delivery auditor (its exit code the gate);
- ``mvdoctor``, the cross-plane correlator (``--strict`` the CI gate);
- ``mvtop``, the fleet table and its views.

Each runs as ``python -m multiverso_tpu_torch.tools.<name>`` or as a
script by its path, with the original's arguments."""
