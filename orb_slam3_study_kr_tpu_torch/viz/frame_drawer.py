"""2-D frame overlay (the reference's src/FrameDrawer.cc).

Counterpart of ``orb_slam3_study_kr_tpu/viz/frame_drawer.py``, pixel for
pixel.  DrawFrame semantics: the current image with
- green squares + dots on keypoints tracked against the map,
- blue dots on extracted-but-unmatched keypoints,
- a status banner (state, #maps, #keyframes, #landmarks, #matches) —
  the reference's DrawTextInfo.

Pure numpy rasterization (no GUI dependency); returns (H, W, 3) uint8.
"""

import numpy as np

from orb_slam3_study_kr_tpu_torch.pipeline.tracking import TrackState
from orb_slam3_study_kr_tpu_torch.slam_map.map_state import NO_LM

GREEN = np.array([40, 220, 60], np.uint8)
BLUE = np.array([80, 120, 255], np.uint8)
RED = np.array([230, 60, 40], np.uint8)
WHITE = np.array([240, 240, 240], np.uint8)
BLACK = np.array([15, 15, 15], np.uint8)

# 5x7 bitmap font for the status banner (digits + the letters we use).
_GLYPHS = {}


def _def_glyph(ch, rows):
    _GLYPHS[ch] = np.array(
        [[c == "#" for c in r.ljust(5)] for r in rows], bool)


_def_glyph("0", ["#####", "#...#", "#...#", "#...#", "#...#", "#...#", "#####"])
_def_glyph("1", ["..#..", ".##..", "..#..", "..#..", "..#..", "..#..", "#####"])
_def_glyph("2", ["#####", "....#", "....#", "#####", "#....", "#....", "#####"])
_def_glyph("3", ["#####", "....#", "....#", "#####", "....#", "....#", "#####"])
_def_glyph("4", ["#...#", "#...#", "#...#", "#####", "....#", "....#", "....#"])
_def_glyph("5", ["#####", "#....", "#....", "#####", "....#", "....#", "#####"])
_def_glyph("6", ["#####", "#....", "#....", "#####", "#...#", "#...#", "#####"])
_def_glyph("7", ["#####", "....#", "....#", "...#.", "..#..", "..#..", "..#.."])
_def_glyph("8", ["#####", "#...#", "#...#", "#####", "#...#", "#...#", "#####"])
_def_glyph("9", ["#####", "#...#", "#...#", "#####", "....#", "....#", "#####"])
for ch, rows in {
    "A": ["..#..", ".#.#.", "#...#", "#####", "#...#", "#...#", "#...#"],
    "B": ["####.", "#...#", "#...#", "####.", "#...#", "#...#", "####."],
    "C": ["#####", "#....", "#....", "#....", "#....", "#....", "#####"],
    "D": ["####.", "#...#", "#...#", "#...#", "#...#", "#...#", "####."],
    "E": ["#####", "#....", "#....", "####.", "#....", "#....", "#####"],
    "F": ["#####", "#....", "#....", "####.", "#....", "#....", "#...."],
    "G": ["#####", "#....", "#....", "#.###", "#...#", "#...#", "#####"],
    "H": ["#...#", "#...#", "#...#", "#####", "#...#", "#...#", "#...#"],
    "I": ["#####", "..#..", "..#..", "..#..", "..#..", "..#..", "#####"],
    "K": ["#...#", "#..#.", "#.#..", "##...", "#.#..", "#..#.", "#...#"],
    "L": ["#....", "#....", "#....", "#....", "#....", "#....", "#####"],
    "M": ["#...#", "##.##", "#.#.#", "#...#", "#...#", "#...#", "#...#"],
    "N": ["#...#", "##..#", "#.#.#", "#..##", "#...#", "#...#", "#...#"],
    "O": ["#####", "#...#", "#...#", "#...#", "#...#", "#...#", "#####"],
    "P": ["####.", "#...#", "#...#", "####.", "#....", "#....", "#...."],
    "R": ["####.", "#...#", "#...#", "####.", "#.#..", "#..#.", "#...#"],
    "S": ["#####", "#....", "#....", "#####", "....#", "....#", "#####"],
    "T": ["#####", "..#..", "..#..", "..#..", "..#..", "..#..", "..#.."],
    "U": ["#...#", "#...#", "#...#", "#...#", "#...#", "#...#", "#####"],
    "Y": ["#...#", "#...#", ".#.#.", "..#..", "..#..", "..#..", "..#.."],
    "Z": ["#####", "....#", "...#.", "..#..", ".#...", "#....", "#####"],
    ":": [".....", "..#..", ".....", ".....", ".....", "..#..", "....."],
    "_": [".....", ".....", ".....", ".....", ".....", ".....", "#####"],
    "-": [".....", ".....", ".....", "#####", ".....", ".....", "....."],
    " ": [".....", ".....", ".....", ".....", ".....", ".....", "....."],
    "/": ["....#", "....#", "...#.", "..#..", ".#...", "#....", "#...."],
}.items():
    _def_glyph(ch, rows)


def _draw_text(img, x, y, text, color=WHITE):
    for ch in text.upper():
        g = _GLYPHS.get(ch)
        if g is not None:
            h, w = g.shape
            y1, x1 = min(y + h, img.shape[0]), min(x + w, img.shape[1])
            patch = img[y:y1, x:x1]
            patch[g[: y1 - y, : x1 - x]] = color
        x += 6
    return img


def _draw_square(img, u, v, r, color):
    H, W = img.shape[:2]
    u0, u1 = max(u - r, 0), min(u + r, W - 1)
    v0, v1 = max(v - r, 0), min(v + r, H - 1)
    if 0 <= v - r < H:
        img[v - r, u0:u1 + 1] = color
    if 0 <= v + r < H:
        img[v + r, u0:u1 + 1] = color
    if 0 <= u - r < W:
        img[v0:v1 + 1, u - r] = color
    if 0 <= u + r < W:
        img[v0:v1 + 1, u + r] = color


class FrameDrawer:
    """Renders the tracking state over the current frame."""

    def __init__(self, system=None):
        self.system = system

    def draw(self, img, frame, state=None, stats=None):
        """(H, W[,3]) image + Frame -> (H+banner, W, 3) uint8 overlay."""
        img = np.asarray(img)
        if img.ndim == 2:
            rgb = np.repeat(
                np.clip(img, 0, 255).astype(np.uint8)[..., None], 3, axis=2)
        else:
            rgb = np.clip(img, 0, 255).astype(np.uint8).copy()
        H, W = rgb.shape[:2]

        n_tracked = 0
        if frame is not None and frame.uv is not None:
            uv = np.round(frame.uv).astype(int)
            tracked = (frame.kp_lm != NO_LM) & frame.valid
            fresh = (frame.kp_lm == NO_LM) & frame.valid
            for u, v in uv[fresh]:
                if 0 <= v < H and 0 <= u < W:
                    rgb[v, u] = BLUE
            for u, v in uv[tracked]:
                if 0 <= v < H and 0 <= u < W:
                    _draw_square(rgb, u, v, 3, GREEN)
                    rgb[v, u] = GREEN
            n_tracked = int(tracked.sum())

        banner = np.zeros((14, W, 3), np.uint8)
        banner[:] = BLACK
        state = state if state is not None else (
            self.system.state if self.system else None)
        parts = []
        if state is not None:
            name = state.name if isinstance(state, TrackState) else str(state)
            parts.append(name.replace("_", " "))
        if stats:
            parts.append(f"MAPS: {stats.get('n_maps', 1)}")
            parts.append(f"KFS: {stats.get('n_kf', 0)}")
            parts.append(f"MPS: {stats.get('n_lm', 0)}")
        parts.append(f"MATCHES: {n_tracked}")
        _draw_text(banner, 4, 3, "  ".join(parts),
                   GREEN if n_tracked else RED)
        return np.concatenate([rgb, banner], axis=0)
