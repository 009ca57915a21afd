"""plslam — point-line visual-inertial SLAM in JAX.

A from-scratch JAX/XLA re-design with the capabilities of the
HeadReaper-hc/PL-inertial-slam reference (C++/ROS/Ceres PL-VIO stack; see
SURVEY.md for the component-by-component mapping).

Layout:
  plslam.utils     geometry, timers, metrics logging       (ref: vins_estimator/src/utility/)
  plslam.ops       cameras, lines, imu, calibration       (ref: camera_model/, factor/)
  plslam.models    frontend, feature table, estimator,
                   solver, marginalization, pose graph     (ref: feature_tracker/, vins_estimator/, pose_graph/)
  plslam.parallel  mesh + distributed BA                   (new; no reference equivalent)
  plslam.io        EuRoC loader, synthetic sim, config,
                   trajectory writers                      (ref: config/*.yaml, benchmark_publisher/)
  plslam.eval      ATE/RPE metrics                         (ref: external evo tooling)
"""

__version__ = "0.1.0"
