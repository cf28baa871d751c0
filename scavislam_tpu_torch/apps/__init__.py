"""Command-line entry points and viewers: ``stereo_slam`` (SLAM over a disk
sequence or a synthetic one), ``mono_vo`` (monocular odometry),
``dump_sequence`` (record a sequence to disk), ``create_dictionary``
(train a bag-of-words vocabulary), and the headless viewers
``visualize``, ``map3d`` and ``watch``."""
