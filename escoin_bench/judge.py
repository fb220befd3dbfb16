"""The comparison that decides ``correct``.

Each answer is an image's logits.  Its error is the largest gap between
the program's logit and the reference's, over the image's classes, as a
share of the reference's largest logit magnitude; the number compared is
the worst error over every answer compared.

The control, the reference itself computed in TF32 (the nearest precision
below the configurations' f32 with TF32 off) and put in the program's
place in the timed path, has to come out not correct.
"""
from __future__ import annotations

import numpy as np


def image_errors(y: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """(N,) errors of N answers (N, classes) against the reference."""
    y = np.asarray(y, np.float64)
    ref = np.asarray(ref, np.float64)
    gap = np.abs(y - ref).max(axis=1)
    scale = np.abs(ref).max(axis=1)
    err = gap / np.maximum(scale, np.finfo(np.float32).tiny)
    return np.where(np.isfinite(err), err, np.inf)


def tf32_control(cell, config, seed, device):
    """The control as an engine hook (``Ctx.engine_hook``): the reference
    itself in the program's place, in TF32, over the benchmark's own
    weights from ``seed``, on whatever the window hands the engine.  A run
    of the cell with it has to come out not correct."""
    from escoin_bench import weights
    from escoin_bench.reference import cnn as ref

    tr = cell["traffic"]
    image = tr["image"] if cell["driver"] == "offline" else max(tr["buckets"])
    convs, fcs = ref.walk_shapes(config["layers"],
                                 (config["in_channels"], image, image))
    w = weights.conv_weights(convs, seed, device)
    fcw = ref.fc_weights(fcs, weights.fc_seed(seed), device)

    def hook(engine):
        def control(x, *args, **kw):
            return ref.forward(config["layers"], w, fcw, x, tf32=True)
        return control
    return hook
