"""Host-side image IO (boundary only — device code never touches files).

Loads images as float32 numpy arrays: grayscale (H, W) or RGB (H, W, 3) in
[0, 1]. Uses OpenCV if present, else PIL. Reference fixture images (farmsim /
CADDY pairs under the reference's test/resources) are loaded through here by
the parity tests.

A copy of ``ocean_perception_tpu.utils.image_io``; without OpenCV and PIL
the module still imports (the dataset providers import it), and reading or
writing an image file raises.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

try:
    import cv2  # type: ignore

    _HAVE_CV2 = True
except Exception:  # pragma: no cover
    _HAVE_CV2 = False
    try:
        from PIL import Image  # type: ignore
    except ImportError:
        Image = None


def _require_codec() -> None:
    if not _HAVE_CV2 and Image is None:
        raise ImportError("image files need OpenCV (cv2) or Pillow")


def load_image(path: str, grayscale: bool = False) -> np.ndarray:
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    _require_codec()
    if _HAVE_CV2:
        flag = cv2.IMREAD_GRAYSCALE if grayscale else cv2.IMREAD_COLOR
        im = cv2.imread(path, flag)
        if im is None:
            raise IOError(f"failed to read {path}")
        if not grayscale:
            im = cv2.cvtColor(im, cv2.COLOR_BGR2RGB)
    else:  # pragma: no cover
        pil = Image.open(path)
        pil = pil.convert("L" if grayscale else "RGB")
        im = np.asarray(pil)
    return im.astype(np.float32) / 255.0


def save_image(path: str, image: np.ndarray) -> None:
    arr = np.clip(np.asarray(image), 0.0, 1.0)
    arr8 = (arr * 255.0 + 0.5).astype(np.uint8)
    _require_codec()
    if _HAVE_CV2:
        if arr8.ndim == 3:
            arr8 = cv2.cvtColor(arr8, cv2.COLOR_RGB2BGR)
        cv2.imwrite(path, arr8)
    else:  # pragma: no cover
        Image.fromarray(arr8).save(path)


def load_stereo_pair(left_path: str, right_path: str, grayscale: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    return load_image(left_path, grayscale), load_image(right_path, grayscale)


def reference_resource(name: str, root: Optional[str] = None) -> str:
    """Path to a reference test fixture, e.g. reference_resource('images/fsl1.png'),
    under ``root``, else $OCEAN_REFERENCE_DIR, else ./reference."""
    root = root or os.environ.get("OCEAN_REFERENCE_DIR", "reference")
    return os.path.join(root, "test", "resources", name)
