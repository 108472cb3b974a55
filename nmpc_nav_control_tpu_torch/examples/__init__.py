"""Closed-loop simulation demos, run with ``python -m``: ``sim_pose_goal``
and ``sim_follow_path`` (ports of the JAX package's ``examples/``)."""
