"""Image decoding into dense NumPy planes.

Copy of `colormipsearch_tpu/imageproc/io.py`. Counterpart of the
reference's image decoding layer (colormipsearch-api
imageprocessing/ImageArrayUtils.java:98-121 and the ImageArray family,
imageprocessing/ImageArray.java) — but instead of flat packed-int
buffers we decode straight into dense NumPy arrays, the layout the
device path wants:

- RGB   -> uint8  [H, W, 3]
- GRAY8 -> uint8  [H, W]
- GRAY16-> uint16 [H, W]

Decoding uses Pillow for all formats (TIFF incl. packbits, PNG, BMP,
GIF, JPEG). The reference's special ranged packbits TIFF read
(ImageArrayUtils.java:184-258) is an I/O optimization for reading a
pixel strip; here full decode feeds a packed preprocessed cache (see
imageproc.store) so steady-state runs never re-decode.
"""

from __future__ import annotations

import enum
import io as _io
import os
from dataclasses import dataclass
from typing import Union

import numpy as np
from PIL import Image as PILImage


class ImageKind(enum.Enum):
    RGB = "rgb"
    GRAY8 = "gray8"
    GRAY16 = "gray16"


@dataclass
class Image:
    """A decoded image: dense pixels + pixel kind.

    Mirrors the role of the reference's ImageArray (ImageArray.java:1-68),
    with numpy arrays instead of packed-int buffers.
    """

    kind: ImageKind
    pixels: np.ndarray  # [H, W, 3] u8 for RGB; [H, W] u8/u16 for gray

    @property
    def height(self) -> int:
        return self.pixels.shape[0]

    @property
    def width(self) -> int:
        return self.pixels.shape[1]

    @property
    def shape(self):
        return (self.height, self.width)

    def rgb_i32(self) -> np.ndarray:
        """RGB channels as int32 [H, W, 3] (zeros-extended for gray)."""
        if self.kind == ImageKind.RGB:
            return self.pixels.astype(np.int32)
        raise ValueError(f"not an RGB image: {self.kind}")

    def gray_i32(self) -> np.ndarray:
        if self.kind == ImageKind.RGB:
            raise ValueError("not a gray image")
        return self.pixels.astype(np.int32)


IMAGE_EXTENSIONS = (".bmp", ".gif", ".jpg", ".jpeg", ".png", ".tif", ".tiff", ".wbmp")


def is_image_file(name: str) -> bool:
    """Extension-based image sniff (ImageArrayUtils.isImageFile, :68-87)."""
    return name.lower().endswith(IMAGE_EXTENSIONS)


def image_from_array(arr: np.ndarray) -> Image:
    if arr.ndim == 3 and arr.shape[2] in (3, 4):
        if arr.shape[2] == 4:
            arr = arr[:, :, :3]
        return Image(ImageKind.RGB, np.ascontiguousarray(arr.astype(np.uint8)))
    if arr.ndim == 2:
        if arr.dtype == np.uint16:
            return Image(ImageKind.GRAY16, np.ascontiguousarray(arr))
        return Image(ImageKind.GRAY8, np.ascontiguousarray(arr.astype(np.uint8)))
    raise ValueError(f"unsupported array shape {arr.shape}")


def _from_pil(img: PILImage.Image) -> Image:
    if img.mode in ("I;16", "I;16B", "I;16L"):
        arr = np.array(img, dtype=np.uint16)
        return Image(ImageKind.GRAY16, arr)
    if img.mode == "I":
        # 32-bit integer gray (PIL may promote 16-bit PNG): clamp to u16
        arr = np.array(img, dtype=np.int32)
        return Image(ImageKind.GRAY16, arr.astype(np.uint16))
    if img.mode == "L":
        return Image(ImageKind.GRAY8, np.array(img, dtype=np.uint8))
    if img.mode in ("RGB", "RGBA", "P", "CMYK", "YCbCr"):
        rgb = img.convert("RGB")
        return Image(ImageKind.RGB, np.array(rgb, dtype=np.uint8))
    # Fall back: let PIL pick a conversion
    return Image(ImageKind.RGB, np.array(img.convert("RGB"), dtype=np.uint8))


def load_image(src: Union[str, bytes, os.PathLike, _io.IOBase]) -> Image:
    """Decode an image from a path, bytes, or stream.

    Counterpart of ImageArrayUtils.readImageArray (ImageArrayUtils.java:98-121).
    """
    if isinstance(src, bytes):
        src = _io.BytesIO(src)
    with PILImage.open(src) as img:
        img.load()
        return _from_pil(img)
