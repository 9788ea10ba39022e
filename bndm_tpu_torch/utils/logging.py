"""Training metrics logging: JSONL always, TensorBoard when available.

Counterpart of ``bndm_tpu/utils/logging.py``: the same ``metrics.jsonl``
records and the same curve files. The curves are drawn with PIL rather than
matplotlib (the GPU machine has no matplotlib): one polyline per series,
autoscaled into a framed plot, in matplotlib's default colours.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

# matplotlib's first three default cycle colours
_COLORS = ((31, 119, 180), (255, 127, 14), (44, 160, 44))


class MetricLogger:
    def __init__(self, logdir, use_tensorboard=True):
        os.makedirs(logdir, exist_ok=True)
        self.logdir = logdir
        self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:  # tensorboard is not installed
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(logdir)

    def log(self, metrics, step):
        rec = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            rec[k] = float(v)
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, float(v), int(step))

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


def plot_series(series, path, size=(640, 480), margin=48):
    """Draw each series of numbers as a polyline against its index."""
    from PIL import Image, ImageDraw

    w, h = size
    img = Image.new("RGB", size, "white")
    draw = ImageDraw.Draw(img)
    box = (margin, margin // 2, w - margin // 2, h - margin)
    draw.rectangle(box, outline="black")
    vals = [np.asarray(s, np.float64) for s in series if len(s)]
    finite = [v[np.isfinite(v)] for v in vals]
    finite = [v for v in finite if v.size]
    if finite:
        lo = min(float(v.min()) for v in finite)
        hi = max(float(v.max()) for v in finite)
        span = hi - lo or 1.0
        n = max(len(v) for v in vals)
        x0, y0, x1, y1 = box
        for i, v in enumerate(vals):
            pts = [(x0 + (x1 - x0) * j / max(n - 1, 1), y1 - (y1 - y0) * (float(y) - lo) / span)
                   for j, y in enumerate(v) if np.isfinite(y)]
            color = _COLORS[i % len(_COLORS)]
            if len(pts) > 1:
                draw.line(pts, fill=color, width=2)
            elif pts:
                draw.point(pts, fill=color)
        draw.text((4, y0), f"{hi:.4g}", fill="black")
        draw.text((4, y1 - 10), f"{lo:.4g}", fill="black")
        draw.text((x1 - 40, y1 + 6), f"{n - 1}", fill="black")
    img.save(path)


def save_loss_curve(losses, path):
    """losses.png: the loss of every step."""
    plot_series([losses], path)


def save_sched_param_curves(p0, p1, p2, path):
    """scheduler_params.png: tau, s and e of every step."""
    plot_series([p0, p1, p2], path)
