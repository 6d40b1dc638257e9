"""camera_fps: camera frames finished in the window, cameras times fleet
calls, over the window's seconds (host clock)."""


def read(rec):
    cams = rec.data.get("cameras")
    if not cams or rec.window_s <= 0:
        return None
    return cams * rec.attempted / rec.window_s
