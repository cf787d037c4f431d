"""Seeded synthetic videos: a textured background that pans, with textured
boxes that move and bounce, one box per object, and their label maps.

Everything is made on the host with numpy from one seed, in a few array
operations per frame. The sizes never depend on the seed: only where the
boxes start, how they move and what the textures hold.
"""

from __future__ import annotations

import numpy as np


def _texture(rng, h, w, cell):
    """A blocky uint8 texture (h, w, 3) of ``cell``-pixel squares."""
    coarse = rng.integers(0, 256, (h // cell + 1, w // cell + 1, 3), dtype=np.uint8)
    return np.repeat(np.repeat(coarse, cell, 0), cell, 1)[:h, :w]


def moving_boxes(seed: int, T: int, hw, n_objs: int):
    """-> (frames (T, H, W, 3) uint8, labels (T, H, W) uint8: 0 background,
    k for box k). Each box is about a fifth of the frame a side, starts at
    a seeded place and moves a seeded 2-10 pixels a frame, bouncing off the
    edges; later boxes are drawn over earlier ones."""
    rng = np.random.default_rng(seed)
    H, W = hw
    pan = int(rng.integers(1, 4))
    bg = _texture(rng, H, W + pan * T, 8)
    frames = np.empty((T, H, W, 3), np.uint8)
    labels = np.zeros((T, H, W), np.uint8)
    boxes = []
    for k in range(n_objs):
        bh, bw = int(rng.integers(H // 6, H // 3)), int(rng.integers(W // 6, W // 3))
        pos = np.array([rng.integers(0, H - bh), rng.integers(0, W - bw)], dtype=np.int64)
        vel = rng.integers(2, 11, 2) * rng.choice([-1, 1], 2)
        boxes.append((bh, bw, pos, vel, _texture(rng, bh, bw, 4 + 2 * k)))
    for t in range(T):
        frames[t] = bg[:, pan * t:pan * t + W]
        for k, (bh, bw, pos, vel, tex) in enumerate(boxes, start=1):
            y, x = pos
            frames[t, y:y + bh, x:x + bw] = tex
            labels[t, y:y + bh, x:x + bw] = k
            for a, lim in ((0, H - bh), (1, W - bw)):
                nxt = pos[a] + vel[a]
                if not 0 <= nxt <= lim:
                    vel[a] = -vel[a]
                    nxt = pos[a] + vel[a]
                pos[a] = min(max(nxt, 0), lim)
    return frames, labels

