"""Entry points: ``mesh_launch`` (on-device EASGD) and ``launch`` (--np 1)."""
