"""Host pipeline: monitors and the SLAM system shell (port)."""
