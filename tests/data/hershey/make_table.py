"""Writes ``sipmask_tpu_torch/data/hershey.py``: the glyphs of printable
ASCII as ``cv2.putText(img, text, org, cv2.FONT_HERSHEY_SIMPLEX, 0.5,
color, 1)`` draws them (needs cv2):

    python tests/data/hershey/make_table.py

opencv-python 5.0 draws text antialiased: a coverage a (0..255) a pixel,
blended as (bg (255 - a) + color a + 127) // 255. It draws each glyph the
same way at every whole-pixel origin and moves the origin by a whole
number of pixels a glyph, so a glyph is its advance in pixels (where an
'I' after it lands) and its coverage drawn alone. The script then draws
strings of every glyph, and labels as ``show_result`` writes them, over
random images, both with cv2 and with ``draw.put_text`` from the table,
and fails unless every pixel agrees.
"""

import os
import random
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
sys.path.insert(0, ROOT)

FONT, SCALE = 0, 0.5            # cv2.FONT_HERSHEY_SIMPLEX at show_result's
ORG = (20, 40)                  # where a glyph is drawn on its canvas
CANVAS = (64, 96)


def render(cv2, text, org=ORG):
    """The coverage cv2 draws for ``text``: white on black, 0..255."""
    img = np.zeros(CANVAS, np.uint8)
    cv2.putText(img, text, org, FONT, SCALE, 255, 1)
    return img


def bitmap(cover, x0):
    """(dx, dy, rows) of a glyph's coverage: offsets of its bounding box
    from the column ``x0`` and ORG's row, each row two hex digits a
    pixel."""
    ys, xs = np.nonzero(cover)
    if not len(ys):
        return (0, 0, ())
    top, left = ys.min(), xs.min()
    rows = tuple("".join(f"{v:02x}" for v in r)
                 for r in cover[top:ys.max() + 1, left:xs.max() + 1])
    return (int(left - x0), int(top - ORG[1]), rows)


def main():
    import cv2
    glyphs = {}

    def last_col(text):
        """The right edge of the last glyph's own pixels in ``text``."""
        mine = (render(cv2, text) > 0) & (render(cv2, text[:-1]) == 0)
        return int(np.nonzero(mine.any(0))[0].max())
    base = last_col("I")
    for code in range(32, 127):
        ch = chr(code)
        glyphs[ch] = (last_col(ch + "I") - base,
                      bitmap(render(cv2, ch), ORG[0]))
    lines = ['"""The glyphs of printable ASCII as ``cv2.putText(img, text, org,',
             "cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 1)`` draws them:",
             "{character: (advance in pixels, (dx, dy, rows))}: the offset",
             "of its coverage's box from the glyph's origin, and its rows of",
             "coverage (0..255), two hex digits a pixel. Written by",
             "``tests/data/hershey/make_table.py`` from cv2's renders.\"\"\"",
             "", "GLYPHS = {"]
    for ch, entry in glyphs.items():
        lines.append(f"    {ch!r}: {entry!r},")
    lines.append("}")
    path = os.path.join(ROOT, "sipmask_tpu_torch", "data", "hershey.py")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    import importlib
    from sipmask_tpu_torch.data import draw, hershey
    importlib.reload(hershey)
    importlib.reload(draw)
    rnd = random.Random(0)
    printable = [chr(c) for c in range(32, 127)]
    texts = ["".join(printable[i:i + 6]) for i in range(0, 95, 5)]
    texts += ["a" + t for t in texts]
    texts += [f"{w} {rnd.random():.2f}" for w in
              ("person", "bicycle", "traffic light", "toothbrush", "c7",
               "id12", "id0")]
    texts += ["".join(rnd.choice(printable) for _ in range(8))
              for _ in range(300)]
    bad = []
    for text in texts:
        for org in ((3, 30), (4, 31), (-5, 6), (60, 90)):
            want = np.random.RandomState(len(bad)).randint(
                0, 256, (100, 160, 3)).astype(np.uint8)
            got = want.copy()
            cv2.putText(want, text, org, FONT, SCALE, (10, 200, 255), 1)
            draw.put_text(got, text, org, (10, 200, 255))
            if not (got == want).all():
                bad.append((text, org, int((got != want).any(-1).sum())))
    print(f"wrote {path}: {len(glyphs)} glyphs; {len(texts)} strings at 4 "
          f"origins each, {len(bad)} differ from cv2's: {bad[:10]}")
    if bad:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
