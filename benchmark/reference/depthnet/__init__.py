"""Frozen copies of the port's depth-network modules
(``gs_init_tpu_torch/models/common.py``, ``dpt.py``, ``vit.py``,
``raft_dpt.py``, unchanged) and of its Metric3D v2 network with its pre- and
post-processing (``metric3d.py``, see its docstring for the departures)."""
