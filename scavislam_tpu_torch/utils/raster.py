"""A small numpy rasterizer for the headless viewers (apps/visualize.py).

The JAX package draws its viewer images with PIL's ``ImageDraw``; the port
draws the same primitives itself, on (H, W, 3) uint8 arrays, so that it
needs no imaging library. A render function first builds its list of
:class:`Prim` in pixel coordinates (what a test compares with the twin's
``ImageDraw`` calls) and then hands it to :func:`rasterize`.

The primitives follow ``ImageDraw``'s integer rules, so that images agree
with PIL's outside text boxes:

- coordinates are truncated toward zero (PIL casts them with ``(int)``);
- ``point``: one pixel;
- ``line`` of width 1: Bresenham between consecutive vertices, the last
  vertex drawn; width > 1: each segment filled as PIL's wide-line
  parallelogram by a scanline fill;
- ``ellipse`` inside the box (x0, y0)-(x1, y1), filled or as a 1-pixel
  outline, by PIL's quarter-ellipse stepping on a doubled integer grid;
- ``rectangle``: filled, rows y0..y1 and columns x0..x1 inclusive;
- ``text``: a fixed 5x7 bitmap font (ASCII 32-126, 6 px advance); PIL's
  default font differs, so text boxes are not compared.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Prim(NamedTuple):
    """One drawing primitive. `xy` is a tuple of (x, y) pixel pairs: one
    for a point or text, two for an ellipse's or rectangle's box, the
    vertices of a line."""

    kind: str  # "point" | "line" | "ellipse" | "rectangle" | "text"
    xy: tuple
    fill: tuple = None
    outline: tuple = None
    width: int = 1
    text: str = None


def blank(size, color) -> np.ndarray:
    """A (height, width, 3) uint8 image of one colour; size = (w, h)."""
    w, h = size
    img = np.empty((h, w, 3), np.uint8)
    img[:] = color
    return img


def rasterize(img: np.ndarray, prims) -> np.ndarray:
    """Draw `prims` in order onto `img` (modified in place, returned)."""
    for p in prims:
        _DRAW[p.kind](img, p)
    return img


# -- integer primitives ----------------------------------------------------- #

def _i(x) -> int:
    return int(x)  # toward zero, as PIL's (int) cast


def _hline(img, x0, y, x1, color):
    h, w = img.shape[:2]
    if not 0 <= y < h:
        return
    if x0 > x1:
        x0, x1 = x1, x0
    if x0 >= w or x1 < 0:
        return
    img[y, max(x0, 0):min(x1, w - 1) + 1] = color


def _point(img, x, y, color):
    h, w = img.shape[:2]
    if 0 <= x < w and 0 <= y < h:
        img[y, x] = color


def _bresenham(img, x0, y0, x1, y1, color):
    """PIL's integer line: both ends for axis-aligned segments, all but
    the last pixel otherwise (the caller draws the last vertex)."""
    dx, dy = abs(x1 - x0), abs(y1 - y0)
    xs = 1 if x1 >= x0 else -1
    ys = 1 if y1 >= y0 else -1
    if dx == 0:
        for y in range(min(y0, y1), max(y0, y1) + 1):
            _point(img, x0, y, color)
    elif dy == 0:
        _hline(img, x0, y0, x1, color)
    elif dx > dy:
        e, n = 2 * dy - dx, dx
        for _ in range(n):
            _point(img, x0, y0, color)
            if e >= 0:
                y0 += ys
                e -= 2 * dx
            e += 2 * dy
            x0 += xs
    else:
        e, n = 2 * dx - dy, dy
        for _ in range(n):
            _point(img, x0, y0, color)
            if e >= 0:
                x0 += xs
                e -= 2 * dy
            e += 2 * dx
            y0 += ys


def _round_up(f: float) -> int:  # nearest, halves up in magnitude
    return int(np.floor(f + 0.5)) if f >= 0 else -int(np.floor(-f + 0.5))


def _round_down(f: float) -> int:  # nearest, halves down in magnitude
    return int(np.ceil(f - 0.5)) if f >= 0 else -int(np.ceil(-f - 0.5))


def _fill_polygon(img, verts, color):
    """Scanline fill of an integer polygon: horizontal edges as spans, each
    row's span pairs from the sorted edge crossings, filled from the
    crossing rounded up to the crossing rounded down."""
    edges = []
    n = len(verts)
    for k in range(n):
        (x0, y0), (x1, y1) = verts[k], verts[(k + 1) % n]
        if y0 == y1:
            _hline(img, x0, y0, x1, color)
            continue
        edges.append((min(y0, y1), max(y0, y1), x0, y0,
                      np.float32(x1 - x0) / np.float32(y1 - y0)))
    if not edges:
        return
    h = img.shape[0]
    ymin = max(min(e[0] for e in edges), 0)
    ymax = min(max(e[1] for e in edges), h)
    for y in range(ymin, ymax + 1):
        xs = []
        for e_lo, e_hi, x0, y0, dxdy in edges:
            if e_lo <= y <= e_hi:
                xs.append(float(np.float32(y - y0) * dxdy + np.float32(x0)))
                if y == e_hi and y < ymax:
                    xs.append(xs[-1])
        xs.sort()
        for k in range(1, len(xs), 2):
            _hline(img, _round_up(xs[k - 1]), y, _round_down(xs[k]), color)


def _wide_segment(img, x0, y0, x1, y1, width, color):
    """PIL's wide line: the parallelogram spanned by the segment and its
    copy offset across it by width - 1 pixels."""
    dx, dy = x1 - x0, y1 - y0
    if dx == 0 and dy == 0:
        _point(img, x0, y0, color)
        return
    big = float(np.hypot(dx, dy))
    small = (width - 1) / 2.0
    r_max = _round_up(small) / big
    r_min = _round_down(small) / big
    dxmin, dxmax = _round_down(r_min * dy), _round_down(r_max * dy)
    dymin, dymax = _round_down(r_min * dx), _round_down(r_max * dx)
    _fill_polygon(img, [(x0 - dxmin, y0 + dymax), (x1 - dxmin, y1 + dymax),
                        (x1 + dxmax, y1 - dymin), (x0 + dxmax, y0 - dymin)],
                  color)


def _quarter(a: int, b: int):
    """The quarter ellipse of semi-axes a/2, b/2 on the doubled integer
    grid: (x, y) from (a, b % 2) up to (a % 2, b)."""
    if a < 0 or b < 0:
        return
    a2, b2 = a * a, b * b
    a2b2 = a2 * b2

    def delta(x, y):
        return abs(a2 * y * y + b2 * x * x - a2b2)

    cx, cy, ex, ey = a, b % 2, a % 2, b
    while True:
        yield cx, cy
        if cx == ex and cy == ey:
            return
        nx, ny = cx, cy + 2
        nd = delta(nx, ny)
        if nx > 1:
            d = delta(cx - 2, cy + 2)
            if nd > d:
                nx, ny, nd = cx - 2, cy + 2, d
            d = delta(cx - 2, cy)
            if nd > d:
                nx, ny = cx - 2, cy
        cx, cy = nx, ny


def _ellipse_spans(a: int, b: int, w: int):
    """Horizontal spans (x0, y, x1) on the doubled grid of an ellipse ring
    of thickness w between the outer quarter (a, b) and the inner one."""
    outer = _quarter(a, b)
    first = next(outer, None)
    if w < 1 or first is None:
        return
    pr, py = first
    inner = _quarter(a - 2 * (w - 1), b - 2 * (w - 1))
    leftmost = a % 2
    pl = leftmost
    finished = False
    while not finished:
        y, l, r = py, pl, pr
        for cx, cy in outer:
            if cy > y:
                pr, py = cx, cy
                break
        else:
            finished = True
        pl = leftmost
        for cx, cy in inner:
            if cy > y:
                pl = cx
                break
            l = cx
        if (l > 0 or l < r) and y > 0:
            yield (2 if l == 0 else l), y, r
        if y > 0:
            yield -r, y, -l
        if l > 0 or l < r:
            yield (2 if l == 0 else l), -y, r
        yield -r, -y, -l


def _ellipse(img, x0, y0, x1, y1, color, fill):
    a, b = x1 - x0, y1 - y0
    if a < 0 or b < 0:
        return
    for X0, Y, X1 in _ellipse_spans(a, b, a + b if fill else 1):
        _hline(img, x0 + (X0 + a) // 2, y0 + (Y + b) // 2,
               x0 + (X1 + a) // 2, color)


# -- Prim dispatch ---------------------------------------------------------- #

def _draw_point(img, p):
    for x, y in p.xy:
        _point(img, _i(x), _i(y), p.fill)


def _draw_line(img, p):
    pts = [(_i(x), _i(y)) for x, y in p.xy]
    if p.width <= 1:
        for (x0, y0), (x1, y1) in zip(pts, pts[1:]):
            _bresenham(img, x0, y0, x1, y1, p.fill)
        if len(pts) > 1:
            _point(img, *pts[-1], p.fill)
    else:
        for (x0, y0), (x1, y1) in zip(pts, pts[1:]):
            _wide_segment(img, x0, y0, x1, y1, p.width, p.fill)


def _draw_ellipse(img, p):
    (x0, y0), (x1, y1) = p.xy
    box = (_i(x0), _i(y0), _i(x1), _i(y1))
    if p.fill is not None:
        _ellipse(img, *box, p.fill, True)
    if p.outline is not None and p.outline != p.fill:
        _ellipse(img, *box, p.outline, False)


def _draw_rectangle(img, p):
    (x0, y0), (x1, y1) = p.xy
    x0, y0, x1, y1 = _i(x0), _i(y0), _i(x1), _i(y1)
    if y0 > y1:
        y0, y1 = y1, y0
    for y in range(max(y0, 0), min(y1, img.shape[0] - 1) + 1):
        _hline(img, x0, y, x1, p.fill)


def _draw_text(img, p):
    (x, y), = p.xy
    x, y = _i(x), _i(y)
    h, w = img.shape[:2]
    for ch in p.text:
        rows = _FONT[ord(ch) - 32] if 32 <= ord(ch) <= 126 else _FONT[31]
        for r in range(7):
            bits = int(rows[2 * r:2 * r + 2], 16)
            for c in range(5):
                if bits & (0x10 >> c):
                    _point(img, x + c, y + r, p.fill)
        x += 6


_DRAW = {"point": _draw_point, "line": _draw_line, "ellipse": _draw_ellipse,
         "rectangle": _draw_rectangle, "text": _draw_text}

# 5x7 glyphs of ASCII 32-126: seven rows of five bits (the leftmost column
# is 0x10) as two hex digits each
_FONT = (
    "00000000000000", "04040404040004", "0a0a0a00000000", "0a0a1f0a1f0a0a",
    "040f140e051e04", "18190204081303", "0c12140815120d", "0c040800000000",
    "02040808080402", "08040202020408", "0004150e150400", "0004041f040400",
    "000000000c0408", "0000001f000000", "00000000000c0c", "00010204081000",
    "0e11131519110e", "040c040404040e", "0e11010204081f", "1f02040201110e",
    "02060a121f0202", "1f101e0101110e", "0608101e11110e", "1f010204080808",
    "0e11110e11110e", "0e11110f01020c", "000c0c000c0c00", "000c0c000c0408",
    "02040810080402", "00001f001f0000", "08040201020408", "0e110102040004",
    "0e11010d15150e", "0e1111111f1111", "1e11111e11111e", "0e11101010110e",
    "1c12111111121c", "1f10101e10101f", "1f10101e101010", "0e11101711110f",
    "1111111f111111", "0e04040404040e", "0702020202120c", "11121418141211",
    "1010101010101f", "111b1515111111", "11111915131111", "0e11111111110e",
    "1e11111e101010", "0e11111115120d", "1e11111e141211", "0f10100e01011e",
    "1f040404040404", "1111111111110e", "11111111110a04", "1111111515150a",
    "11110a040a1111", "1111110a040404", "1f01020408101f", "0e08080808080e",
    "00100804020100", "0e02020202020e", "040a1100000000", "0000000000001f",
    "08040200000000", "00000e010f110f", "1010161911111e", "00000e1010110e",
    "01010d1311110f", "00000e111f100e", "0609081c080808", "000f11110f010e",
    "10101619111111", "04000c0404040e", "0200060202120c", "10101214181412",
    "0c04040404040e", "00001a15151111", "00001619111111", "00000e1111110e",
    "00001e111e1010", "00000d130f0101", "00001619101010", "00000e100e011e",
    "08081c08080906", "0000111111130d", "00001111110a04", "0000111115150a",
    "0000110a040a11", "000011110f010e", "00001f0204081f", "02040408040402",
    "04040404040404", "08040402040408", "00000815020000",
)
