"""Host utilities (port of ``ocean_perception_tpu.utils``)."""
