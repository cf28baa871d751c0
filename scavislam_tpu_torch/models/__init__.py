"""SLAM models: dense tracker, matcher, pose optimizer, map tables, the
fused frontend step and the stereo frontend."""
