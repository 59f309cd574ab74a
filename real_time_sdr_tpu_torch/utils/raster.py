"""A headless PNG renderer for the figure sheet where matplotlib is not
installed.

``utils.viz._mpl()`` returns pyplot when matplotlib imports and this module
otherwise, so the figure code runs unchanged on a machine without it (the
card's machine has none). It implements the subset of pyplot's interface
that ``utils.viz``, ``viz`` and ``_viz_ber`` call: ``subplots``, ``figure``
/ ``add_subplot``, and on an axes ``plot``, ``semilogy``, ``scatter``,
``imshow``, ``axhline``, ``axvline`` and the limit setters. Lines, points
and images are rasterized with numpy into an RGB canvas of figsize x dpi
pixels and written as a PNG (zlib, no other dependency); every text call
(titles, labels, ticks, legends, annotations, colour bars) is accepted and
draws nothing.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["subplots", "figure", "close", "Figure", "Axes", "write_png"]

_NAMED = {"k": "#000000"}      # the one colour name the figures use
_CYCLE = ("#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd")
# viridis at five stops, linearly interpolated between them
_VIRIDIS = np.array([[68, 1, 84], [59, 82, 139], [33, 145, 140],
                     [94, 201, 98], [253, 231, 37]], np.float64) / 255.0


def _rgb(color, k: int) -> np.ndarray:
    c = _NAMED.get(color, color) if color else _CYCLE[k % len(_CYCLE)]
    return np.array([int(c[i:i + 2], 16) for i in (1, 3, 5)]) / 255.0


def write_png(path: str, rgb: np.ndarray) -> None:
    """rgb (H, W, 3) floats in [0, 1] -> an 8-bit RGB PNG file."""
    img = np.clip(np.round(rgb * 255.0), 0, 255).astype(np.uint8)
    h, w, _ = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          img.reshape(h, 3 * w)], axis=1).tobytes()

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6))
                + chunk(b"IEND", b""))


class Axes:
    """One panel: records what is drawn, rasterizes it on ``draw``."""

    def __init__(self):
        self._lines: list = []     # (x, y, rgb, alpha, width)
        self._points: list = []    # (x, y, rgb, alpha)
        self._image = None         # (array, extent, vmin, vmax)
        self._rules: list = []     # ("h" | "v", value, rgb)
        self._xlim = self._ylim = None
        self._logy = False

    # -- what draws --------------------------------------------------------

    def plot(self, *args, color=None, alpha=1.0, lw=None, linewidth=None,
             **_):
        arrays = [a for a in args if not isinstance(a, str)]
        y = np.asarray(arrays[-1], np.float64).ravel()
        x = (np.asarray(arrays[0], np.float64).ravel() if len(arrays) > 1
             else np.arange(len(y), dtype=np.float64))
        width = lw or linewidth or 1.0
        self._lines.append((x, y, _rgb(color, len(self._lines)), alpha,
                            width))

    def semilogy(self, *args, **kw):
        self._logy = True
        self.plot(*args, **kw)

    def scatter(self, x, y, s=4, alpha=1.0, color=None, **_):
        self._points.append((np.asarray(x, np.float64).ravel(),
                             np.asarray(y, np.float64).ravel(),
                             _rgb(color, 0), alpha))

    def imshow(self, img, extent=None, vmin=None, vmax=None, **_):
        img = np.asarray(img, np.float64)
        ext = extent or [0, img.shape[1], img.shape[0], 0]
        self._image = (img, ext,
                       np.nanmin(img) if vmin is None else vmin,
                       np.nanmax(img) if vmax is None else vmax)
        return self._image

    def axhline(self, y, color="k", **_):
        self._rules.append(("h", float(y), _rgb(color, 0)))

    def axvline(self, x, color="k", **_):
        self._rules.append(("v", float(x), _rgb(color, 0)))

    def set_xlim(self, lim):
        self._xlim = (float(lim[0]), float(lim[1]))

    def set_ylim(self, lim):
        self._ylim = (float(lim[0]), float(lim[1]))

    # -- text and decoration: accepted, not drawn ---------------------------

    def _ignored(self, *args, **kw):
        return None

    set_title = set_xlabel = set_ylabel = set_xticks = set_yticks = _ignored
    grid = legend = annotate = text = _ignored

    # -- rasterization -----------------------------------------------------

    def _limits(self):
        xs = [a[0] for a in self._lines] + [a[0] for a in self._points]
        ys = [a[1] for a in self._lines] + [a[1] for a in self._points]
        if self._image is not None:
            ext = self._image[1]
            xs.append(np.array(ext[:2], np.float64))
            ys.append(np.array(ext[2:], np.float64))

        def span(arrays, fixed, log=False):
            if fixed is not None:
                lo, hi = fixed
            else:
                v = np.concatenate(arrays) if arrays else np.zeros(1)
                v = v[np.isfinite(v)]
                if log:
                    v = np.log10(v[v > 0])
                lo, hi = (float(v.min()), float(v.max())) if v.size else (0,
                                                                         1)
                pad = 0.05 * (hi - lo) if hi > lo else 0.5
                return lo - pad, hi + pad
            if log:
                return np.log10(max(lo, 1e-300)), np.log10(max(hi, 1e-300))
            return lo, hi
        return span(xs, self._xlim), span(ys, self._ylim, self._logy)

    def draw(self, canvas: np.ndarray, box: tuple) -> None:
        """Rasterize into canvas (H, W, 3) inside box (top, left, h, w)."""
        top, left, h, w = box
        canvas[top:top + h, left:left + w] = 1.0
        (x0, x1), (y0, y1) = self._limits()
        sx = (w - 1) / (x1 - x0) if x1 != x0 else 1.0
        sy = (h - 1) / (y1 - y0) if y1 != y0 else 1.0

        def px(x, y):
            if self._logy:
                with np.errstate(divide="ignore", invalid="ignore"):
                    y = np.log10(y)
            return (left + (x - x0) * sx, top + (h - 1) - (y - y0) * sy)

        def blend(cols, rows, rgb, alpha):
            ok = ((rows >= top) & (rows < top + h) & (cols >= left)
                  & (cols < left + w))
            r, c = rows[ok], cols[ok]
            canvas[r, c] = (1.0 - alpha) * canvas[r, c] + alpha * rgb

        if self._image is not None:
            img, ext, vmin, vmax = self._image
            cx, cy = px(np.array(ext[:2], np.float64),
                        np.array(ext[2:], np.float64))
            c0, c1 = sorted(int(round(v)) for v in cx)
            r0, r1 = sorted(int(round(v)) for v in cy)
            c0, c1 = max(c0, left), min(c1, left + w - 1)
            r0, r1 = max(r0, top), min(r1, top + h - 1)
            if c1 >= c0 and r1 >= r0:
                rows = np.linspace(0, img.shape[0] - 1, r1 - r0 + 1)
                cols = np.linspace(0, img.shape[1] - 1, c1 - c0 + 1)
                sub = img[np.round(rows).astype(int)][:, np.round(
                    cols).astype(int)]
                t = np.clip((sub - vmin) / max(vmax - vmin, 1e-300), 0, 1)
                t = np.nan_to_num(t) * (len(_VIRIDIS) - 1)
                i = np.minimum(t.astype(int), len(_VIRIDIS) - 2)
                f = (t - i)[..., None]
                canvas[r0:r1 + 1, c0:c1 + 1] = ((1 - f) * _VIRIDIS[i]
                                                + f * _VIRIDIS[i + 1])
        for kind, v, rgb in self._rules:
            if kind == "h":
                row = int(round(px(np.array([x0]), np.array([v]))[1][0]))
                blend(np.arange(left, left + w), np.full(w, row), rgb, 1.0)
            else:
                col = int(round(px(np.array([v]), np.array([y0]))[0][0]))
                blend(np.full(h, col), np.arange(top, top + h), rgb, 1.0)
        for x, y, rgb, alpha, width in self._lines:
            cx, cy = px(x, y)
            good = np.isfinite(cx) & np.isfinite(cy)
            for a, b in _runs(good):
                _polyline(cx[a:b], cy[a:b], rgb, alpha,
                          max(1, int(round(width))), blend)
        for x, y, rgb, alpha in self._points:
            cx, cy = px(x, y)
            good = np.isfinite(cx) & np.isfinite(cy)
            cx, cy = np.round(cx[good]).astype(int), np.round(
                cy[good]).astype(int)
            for dr in (0, 1):
                for dc in (0, 1):
                    blend(cx + dc, cy + dr, rgb, alpha)


def _runs(mask: np.ndarray):
    """(start, stop) of each run of True in mask."""
    d = np.diff(np.concatenate([[0], mask.astype(np.int8), [0]]))
    return zip(np.flatnonzero(d == 1), np.flatnonzero(d == -1))


def _polyline(cx, cy, rgb, alpha, width, blend):
    """Pixels along each segment, one per pixel step, ``width`` rows
    thick."""
    if len(cx) == 1:
        blend(np.round(cx).astype(int), np.round(cy).astype(int), rgb, alpha)
        return
    steps = np.maximum(np.ceil(np.maximum(np.abs(np.diff(cx)),
                                          np.abs(np.diff(cy)))), 1)
    steps = np.minimum(steps, 4096).astype(int)
    seg = np.repeat(np.arange(len(steps)), steps)
    t = (np.arange(steps.sum()) - np.repeat(np.cumsum(steps) - steps,
                                             steps)) / steps[seg]
    xs = np.round(cx[seg] + t * (cx[seg + 1] - cx[seg])).astype(int)
    ys = np.round(cy[seg] + t * (cy[seg + 1] - cy[seg])).astype(int)
    for k in range(width):
        blend(xs, ys + k - width // 2, rgb, alpha)


class Figure:
    """A grid of axes; ``savefig`` rasterizes them into one PNG."""

    def __init__(self, figsize=(6.4, 4.8)):
        self.figsize = figsize
        self._axes: list = []      # (row, col, nrows, ncols, Axes)

    def add_subplot(self, nrows: int, ncols: int, index: int) -> Axes:
        ax = Axes()
        self._axes.append(((index - 1) // ncols, (index - 1) % ncols, nrows,
                           ncols, ax))
        return ax

    def colorbar(self, *args, **kw):
        return None

    def tight_layout(self, *args, **kw):
        return None

    def savefig(self, path: str, dpi: int = 100, **_):
        wpx = max(16, int(round(self.figsize[0] * dpi)))
        hpx = max(16, int(round(self.figsize[1] * dpi)))
        canvas = np.full((hpx, wpx, 3), 0.94)
        for row, col, nrows, ncols, ax in self._axes:
            cell_h, cell_w = hpx // nrows, wpx // ncols
            m_h, m_w = max(2, cell_h // 10), max(2, cell_w // 12)
            ax.draw(canvas, (row * cell_h + m_h, col * cell_w + m_w,
                             cell_h - 2 * m_h, cell_w - 2 * m_w))
        write_png(path, canvas)


def figure(figsize=(6.4, 4.8), **_) -> Figure:
    return Figure(figsize)


def subplots(nrows: int = 1, ncols: int = 1, figsize=(6.4, 4.8), **_):
    """(fig, axes) as pyplot gives them: one Axes, or a 1-D array of them
    when there is one row or one column."""
    fig = Figure(figsize)
    axes = [fig.add_subplot(nrows, ncols, k + 1)
            for k in range(nrows * ncols)]
    if len(axes) == 1:
        return fig, axes[0]
    return fig, np.array(axes, dtype=object)


def close(fig=None) -> None:
    return None
