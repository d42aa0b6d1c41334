"""Drawing of ``show_result`` and the demos without cv2: cv2's pixels for
the calls they make, on uint8 BGR images in place.

- ``rectangle(img, pt1, pt2, color)``: ``cv2.rectangle`` with thickness 2
  and LINE_8: each side a band three pixels wide between its corners (cv2
  fills each side's thick quad and caps its end with a radius-1 disc), so
  the outer corner pixels stay unset.
- ``put_text(img, text, org, color)``: ``cv2.putText(img, text, org,
  FONT_HERSHEY_SIMPLEX, 0.5, color, 1)`` as opencv-python 5.0 draws it,
  antialiased, glyph by glyph: a table of the glyphs' coverages and
  advances at that scale (``hershey.GLYPHS``, recovered from cv2's renders
  by ``tests/data/hershey/make_table.py``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .hershey import GLYPHS


def put_text(img: np.ndarray, text: str, org: Tuple[int, int],
             color) -> np.ndarray:
    """``cv2.putText(img, text, org, cv2.FONT_HERSHEY_SIMPLEX, 0.5, color,
    1)`` in place: ``org`` is the left end of the text's base line. Glyph
    by glyph, its coverage a (``hershey.GLYPHS``) at its origin is blended
    as cv2 blends it, (bg (255 - a) + color a + 127) // 255, and the
    origin moves by the glyph's advance; characters outside printable
    ASCII draw as '?'. Clipped to the image."""
    h, w = img.shape[:2]
    c = np.asarray(color, np.int64)
    x = int(org[0])
    for ch in text:
        adv, (dx, dy, rows) = GLYPHS.get(ch, GLYPHS["?"])
        if rows:
            a = np.array([[int(r[i:i + 2], 16) for i in range(0, len(r), 2)]
                          for r in rows], np.int64)
            y0, x0 = int(org[1]) + dy, x + dx
            ya, xa = max(y0, 0), max(x0, 0)
            yb, xb = min(y0 + a.shape[0], h), min(x0 + a.shape[1], w)
            if ya < yb and xa < xb:
                a = a[ya - y0:yb - y0, xa - x0:xb - x0]
                if img.ndim == 3:
                    a = a[..., None]
                bg = img[ya:yb, xa:xb].astype(np.int64)
                img[ya:yb, xa:xb] = (bg * (255 - a) + c * a + 127) // 255
        x += adv
    return img


def rectangle(img: np.ndarray, pt1: Tuple[int, int], pt2: Tuple[int, int],
              color) -> np.ndarray:
    """``cv2.rectangle(img, pt1, pt2, color, 2)`` in place (LINE_8, integer
    corners): each side a band of three pixels centred on it, running
    between its corners."""
    (x1, y1), (x2, y2) = (int(v) for v in pt1), (int(v) for v in pt2)
    h, w = img.shape[:2]
    xl, xr = min(x1, x2), max(x1, x2)
    yt, yb = min(y1, y2), max(y1, y2)

    def band(ya, yb_, xa, xb):
        ya, yb_ = max(ya, 0), min(yb_, h - 1)
        xa, xb = max(xa, 0), min(xb, w - 1)
        if ya <= yb_ and xa <= xb:
            img[ya:yb_ + 1, xa:xb + 1] = color
    for y in (y1, y2):
        band(y - 1, y + 1, xl, xr)
    for x in (x1, x2):
        band(yt, yb, x - 1, x + 1)
    return img
