"""Synthetic pose map generators (a copy of tests/util_synth.py on the
port's skeleton tables, so the self-test and the smoke script import
nothing of the JAX package; tests/test_torch_isolation.py holds it equal
to the original).

Builds heatmaps/PAFs for randomly placed people using the same closed-form
GT synthesis math as training (gaussian peaks, unit-vector limb fields) so
post-processing has realistic, decodable inputs without COCO data.
"""

import numpy as np

from ..skeleton import LIMBS, NUM_HEATMAPS, NUM_PAF_CHANNELS, NUM_PARTS

# A rough standing-person template in a unit box: part -> (x, y)
_TEMPLATE = {
    0: (0.50, 0.10), 1: (0.50, 0.22), 2: (0.38, 0.24), 3: (0.34, 0.40),
    4: (0.32, 0.55), 5: (0.62, 0.24), 6: (0.66, 0.40), 7: (0.68, 0.55),
    8: (0.42, 0.52), 9: (0.42, 0.72), 10: (0.42, 0.92), 11: (0.58, 0.52),
    12: (0.58, 0.72), 13: (0.58, 0.92), 14: (0.46, 0.07), 15: (0.54, 0.07),
    16: (0.42, 0.09), 17: (0.58, 0.09),
}


def random_people(rng, n_people, h, w, scale_range=(0.35, 0.8)):
    """Sample keypoint sets (n, 18, 2) in pixel coords of an (h, w) map."""
    people = np.zeros((n_people, NUM_PARTS, 2))
    for i in range(n_people):
        s = rng.uniform(*scale_range) * min(h, w)
        cx = rng.uniform(0.2 * w, 0.8 * w)
        cy = rng.uniform(0.2 * h, 0.8 * h)
        for part, (tx, ty) in _TEMPLATE.items():
            jitter = rng.normal(0, 0.01 * s, 2)
            people[i, part] = (cx + (tx - 0.5) * s + jitter[0],
                               cy + (ty - 0.5) * s + jitter[1])
    return people


def render_maps(people, h, w, sigma=1.5, limb_width=1.0):
    """Render (h, w, 19) heatmaps + (h, w, 38) PAFs at map resolution."""
    heat = np.zeros((h, w, NUM_HEATMAPS), dtype=np.float32)
    paf = np.zeros((h, w, NUM_PAF_CHANNELS), dtype=np.float32)
    count = np.zeros((h, w, len(LIMBS)), dtype=np.int32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for person in people:
        for part in range(NUM_PARTS):
            px, py = person[part]
            if not (0 <= px < w and 0 <= py < h):
                continue
            d2 = (xx - px) ** 2 + (yy - py) ** 2
            g = np.exp(-d2 / (2 * sigma * sigma)) * (d2 < (4 * sigma) ** 2)
            heat[:, :, part] = np.maximum(heat[:, :, part], g)
        for li, (a, b) in enumerate(LIMBS):
            ax, ay = person[a]
            bx, by = person[b]
            if not (0 <= ax < w and 0 <= ay < h and 0 <= bx < w
                    and 0 <= by < h):
                continue
            vec = np.array([bx - ax, by - ay])
            norm = np.linalg.norm(vec)
            if norm < 1e-6:
                continue
            u = vec / norm
            # points within limb_width of the segment
            dx = xx - ax
            dy = yy - ay
            along = dx * u[0] + dy * u[1]
            perp = np.abs(dx * u[1] - dy * u[0])
            mask = (perp <= limb_width) & (along >= -1) & (along <= norm + 1)
            prev = count[:, :, li]
            paf[:, :, 2 * li] = np.where(
                mask, (paf[:, :, 2 * li] * prev + u[0]) / (prev + 1),
                paf[:, :, 2 * li])
            paf[:, :, 2 * li + 1] = np.where(
                mask, (paf[:, :, 2 * li + 1] * prev + u[1]) / (prev + 1),
                paf[:, :, 2 * li + 1])
            count[:, :, li] = prev + mask
    heat[:, :, NUM_PARTS] = np.maximum(
        1.0 - heat[:, :, :NUM_PARTS].max(axis=2), 0.0)
    return heat, paf


def grid_people(n_rows, n_cols, h, w, rng, margin=2.0):
    """Well-separated people on a grid (for crowded-scene cap tests)."""
    people = np.zeros((n_rows * n_cols, NUM_PARTS, 2))
    cell_h = (h - 2 * margin) / n_rows
    cell_w = (w - 2 * margin) / n_cols
    s = 0.9 * min(cell_h, cell_w)
    i = 0
    for r in range(n_rows):
        for c in range(n_cols):
            cx = margin + (c + 0.5) * cell_w
            cy = margin + (r + 0.5) * cell_h
            for part, (tx, ty) in _TEMPLATE.items():
                jitter = rng.normal(0, 0.005 * s, 2)
                people[i, part] = (cx + (tx - 0.5) * s + jitter[0],
                                   cy + (ty - 0.5) * s + jitter[1])
            i += 1
    return people


def synth_example(seed=0, n_people=3, h=46, w=46):
    rng = np.random.RandomState(seed)
    people = random_people(rng, n_people, h, w)
    heat, paf = render_maps(people, h, w)
    # break exact score ties (idealized parallel unit-vector PAFs can make
    # two candidate connections score identically, which real CNN outputs
    # never do; greedy order under exact ties is enumeration-dependent)
    paf = paf + rng.normal(0, 1e-4, paf.shape).astype(np.float32)
    return people, heat, paf
