"""Command-line entry points: ``stereo_slam`` (SLAM over a disk sequence or
a synthetic one) and ``dump_sequence`` (record a sequence to disk)."""
