"""Dense stereo: cost volume and PatchMatch."""
