"""Command-line drivers of the port, run with ``python -m``:

- ``run_euroc``: EuRoC / TUM-VI sequences (mono, mono-inertial, stereo,
  stereo-inertial) from a calibration YAML, several sequences through one
  session, and the EuRoC MH parity table;
- ``run_kitti``: a KITTI odometry sequence (mono or stereo) from its
  calib.txt;
- ``run_synthetic``: the synthetic lateral session with its ATE;
- ``ros_node``: the ROS front end's message core (``main`` needs rospy).

Each takes ``--device`` (default ``cuda``, which raises without a card;
``--device cpu`` runs the plain PyTorch path).
"""
