"""Trainer checkpoint/resume (a copy of ``cpecan_tpu/utils/checkpoint.py``).

The reference's checkpoint story is "the EM model file is the checkpoint"
(rewritten after every M-step, cPecanEm.py:202, scripts/trainModels.py:114).
This module keeps that property (model text files remain reloadable) and
adds what the reference lacks: a versioned, atomic, round-trippable
trainer-state checkpoint (npz arrays + JSON metadata) so an interrupted EM
run resumes from its exact iteration, likelihood trajectory, and RNG state
(SURVEY §5, checkpoint/resume).
"""

import json
import os
import random
import tempfile

import numpy as np

_CKPT_PREFIX = "ckpt_"
_CKPT_SUFFIX = ".npz"


def _ckpt_name(step):
    return f"{_CKPT_PREFIX}{step:08d}{_CKPT_SUFFIX}"


def save_checkpoint(path, step, arrays=None, meta=None):
    """Atomically write one checkpoint file: numeric state in npz arrays,
    JSON-able metadata under the reserved key '__meta__'."""
    arrays = dict(arrays or {})
    payload = {"__meta__": np.frombuffer(
        json.dumps({"step": step, **(meta or {})}).encode(), dtype=np.uint8)}
    for k, v in arrays.items():
        if k == "__meta__":
            raise ValueError("'__meta__' is reserved")
        payload[k] = np.asarray(v)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez(fh, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path


def load_checkpoint(path):
    """Returns (step, arrays dict, meta dict)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    step = meta.pop("step")
    return step, arrays, meta


def rng_state_to_json(rng):
    """random.Random state as JSON-able lists."""
    version, internal, gauss = rng.getstate()
    return [version, list(internal), gauss]


def rng_state_from_json(state):
    rng = random.Random()
    rng.setstate((state[0], tuple(state[1]), state[2]))
    return rng


class CheckpointManager:
    """Directory of step-numbered checkpoints with retention.

    save(step, arrays, meta) -> path; restore() -> (step, arrays, meta) of
    the newest checkpoint or None when the directory is empty.
    """

    def __init__(self, directory, keep=3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _steps(self):
        out = []
        for f in os.listdir(self.directory):
            if f.startswith(_CKPT_PREFIX) and f.endswith(_CKPT_SUFFIX):
                try:
                    out.append(int(f[len(_CKPT_PREFIX):-len(_CKPT_SUFFIX)]))
                except ValueError:
                    continue
        return sorted(out)

    def latest_path(self):
        steps = self._steps()
        if not steps:
            return None
        return os.path.join(self.directory, _ckpt_name(steps[-1]))

    def save(self, step, arrays=None, meta=None):
        path = save_checkpoint(os.path.join(self.directory, _ckpt_name(step)),
                               step, arrays, meta)
        if self.keep is not None:
            for s in self._steps()[:-self.keep]:
                os.unlink(os.path.join(self.directory, _ckpt_name(s)))
        return path

    def restore(self):
        path = self.latest_path()
        if path is None:
            return None
        return load_checkpoint(path)
