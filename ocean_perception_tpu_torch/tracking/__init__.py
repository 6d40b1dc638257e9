"""Sparse front end: detector, LK tracker, stripe matcher, stereo tracker."""
