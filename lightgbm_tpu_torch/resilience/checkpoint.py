"""Crash-safe checkpoint/resume of the full boosting state.

The reference snapshots mid-train by dumping model text every
``snapshot_freq`` iterations (gbdt.cpp:277-281); that is not enough to
CONTINUE a run bit-identically — the objective/bagging RNG position,
early-stopping bookkeeping and the exact f32 score bits are all part of
the training state.  A :class:`Checkpoint` bundles everything
``train()`` needs:

  * model text (reference v3 format — round-trips doubles via %.17g),
  * completed-iteration count,
  * the train score and every valid-set score as EXACT f32 arrays
    (rebuilding scores from trees re-rounds in a different order and
    can drift the last ulp, which would fork the remaining boosting
    trajectory),
  * RNG seed state (``utils/random.py`` streams are pure functions of
    (seed, iteration), so seeds + iteration IS the generator state —
    validated on restore so a changed seed fails instead of silently
    diverging),
  * early-stopping tracker state and the eval-history dict,
  * CEGB coupled-penalty used-feature set, lagged stump bookkeeping,
  * a dataset fingerprint (binning hash + shape + binned-data crc)
    checked on restore so resuming against the wrong binned matrix
    fails loudly.

On disk a checkpoint is ONE ``.npz`` file written via
``io_utils.atomic_write_bytes`` (temp + fsync + atomic rename): a crash
mid-write can never leave a truncated bundle.  :class:`CheckpointManager`
keeps a bounded ring of the newest ``keep`` snapshots plus a ``LATEST``
pointer file.

Copy of ``lightgbm_tpu/resilience/checkpoint.py`` (numpy only) kept inside
the PyTorch port so the port never imports the JAX package.  The on-disk
format is the reference's, so a bundle written by either package resumes
in the other.
"""

from __future__ import annotations

import io
import json
import os
import re
import signal
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from ..io_utils import atomic_write_bytes, atomic_write_text
from ..telemetry.metrics import default_registry
from ..utils.log import log_warning

__all__ = ["Checkpoint", "CheckpointError", "CheckpointManager",
           "TrainingPreempted", "load_checkpoint", "resolve_checkpoint",
           "PreemptionGuard", "reject_checkpointing"]

FORMAT_VERSION = 1
LATEST = "LATEST"
_CKPT_RE = re.compile(r"^ckpt_iter(\d+)\.npz$")

# params recorded into every bundle and compared on restore.  Structural
# drift makes the continuation nonsense -> validate_config raises; soft
# drift only breaks bit-identity -> warns.  engine.py records exactly
# STRUCTURAL + SOFT, so adding a key here is the whole change.
CKPT_STRUCTURAL_KEYS = ("objective", "num_class")
CKPT_SOFT_KEYS = ("num_leaves", "learning_rate", "bagging_fraction",
                  "bagging_freq", "feature_fraction", "use_quantized_grad",
                  "tree_learner")


class CheckpointError(ValueError):
    """A checkpoint could not be written, read, or safely restored."""


def reject_checkpointing(cfg, context: str) -> None:
    """Raise a typed :class:`CheckpointError` when checkpoint/resume
    params are set in a training mode that cannot honor them.

    The multi-model trainer (``train_many``) stacks M boosters' state
    along a vmapped model axis — a shape the per-model bundle format
    cannot capture yet — so a checkpoint written there would resume
    wrong.  The contract is "checkpoint correctly or fail loudly":
    never train silently without the fault tolerance the params asked
    for (covered by the chaos-marked multitrain test)."""
    offending = [k for k, v in (
        ("checkpoint_dir", str(cfg.checkpoint_dir or "")),
        ("snapshot_freq", int(cfg.snapshot_freq) > 0 and
         str(cfg.snapshot_freq)),
        ("resume", str(cfg.resume or "").strip()),
    ) if v]
    if offending:
        raise CheckpointError(
            f"checkpointing/resume ({', '.join(offending)}) is unsupported "
            f"in {context}: the stacked multi-model state cannot be "
            f"captured as per-model bundles yet; drop those params or "
            f"train the models individually via train()")


class TrainingPreempted(RuntimeError):
    """Training was interrupted by SIGTERM/SIGINT after a final
    checkpoint flush.  ``booster`` is the partial model; ``checkpoint``
    the path of the flushed bundle (None when checkpointing was off)."""

    def __init__(self, signum: int, booster=None,
                 checkpoint: Optional[str] = None) -> None:
        name = signal.Signals(signum).name
        super().__init__(
            f"training preempted by {name}"
            + (f"; state checkpointed to {checkpoint}" if checkpoint
               else "; no checkpoint configured"))
        self.signum = signum
        self.booster = booster
        self.checkpoint = checkpoint


@dataclass
class Checkpoint:
    """In-memory form of one snapshot (see module docstring for what each
    field buys).  ``score`` is (N,) or (N,K) float32; ``valid_scores``
    parallel ``valid_names``."""

    iteration: int
    model_text: str
    score: np.ndarray
    valid_names: List[str] = field(default_factory=list)
    valid_scores: List[np.ndarray] = field(default_factory=list)
    eval_history: Dict[str, Dict[str, List[float]]] = field(
        default_factory=dict)
    early_stop: List[Dict[str, Any]] = field(default_factory=list)
    rng_state: Dict[str, int] = field(default_factory=dict)
    fingerprint: Dict[str, Any] = field(default_factory=dict)
    params: Dict[str, Any] = field(default_factory=dict)
    cegb_used: Optional[np.ndarray] = None
    prev_iter_leaves: Optional[List[int]] = None

    # -- serialization -------------------------------------------------------
    def to_bytes(self) -> bytes:
        state = {
            "format": FORMAT_VERSION,
            "iteration": int(self.iteration),
            "valid_names": list(self.valid_names),
            "eval_history": self.eval_history,
            "early_stop": self.early_stop,
            "rng_state": {k: int(v) for k, v in self.rng_state.items()},
            "fingerprint": self.fingerprint,
            "params": self.params,
            "prev_iter_leaves": self.prev_iter_leaves,
        }
        arrays = {
            "state_json": np.frombuffer(
                json.dumps(state).encode("utf-8"), np.uint8),
            "model_text": np.frombuffer(
                self.model_text.encode("utf-8"), np.uint8),
            "score": np.ascontiguousarray(self.score, np.float32),
        }
        for i, vs in enumerate(self.valid_scores):
            arrays[f"valid_score_{i}"] = np.ascontiguousarray(vs, np.float32)
        if self.cegb_used is not None:
            arrays["cegb_used"] = np.ascontiguousarray(self.cegb_used, bool)
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        return buf.getvalue()

    @classmethod
    def from_bytes(cls, data: bytes, source: str = "<bytes>") -> "Checkpoint":
        try:
            z = np.load(io.BytesIO(data), allow_pickle=False)
            state = json.loads(bytes(z["state_json"]).decode("utf-8"))
            if int(state.get("format", -1)) > FORMAT_VERSION:
                raise CheckpointError(
                    f"{source}: checkpoint format {state['format']} is "
                    f"newer than this build understands ({FORMAT_VERSION})")
            valid_names = list(state.get("valid_names", []))
            valid_scores = [np.asarray(z[f"valid_score_{i}"])
                            for i in range(len(valid_names))]
            return cls(
                iteration=int(state["iteration"]),
                model_text=bytes(z["model_text"]).decode("utf-8"),
                score=np.asarray(z["score"]),
                valid_names=valid_names,
                valid_scores=valid_scores,
                eval_history=state.get("eval_history", {}),
                early_stop=state.get("early_stop", []),
                rng_state=state.get("rng_state", {}),
                fingerprint=state.get("fingerprint", {}),
                params=state.get("params", {}),
                cegb_used=(np.asarray(z["cegb_used"])
                           if "cegb_used" in z.files else None),
                prev_iter_leaves=state.get("prev_iter_leaves"),
            )
        except CheckpointError:
            raise
        except Exception as exc:
            raise CheckpointError(
                f"{source}: not a readable checkpoint bundle "
                f"({type(exc).__name__}: {exc})") from exc

    # -- restore-time validation --------------------------------------------
    def validate_dataset(self, train_set) -> None:
        """Fail loudly when the resume dataset's binned matrix differs
        from the one this checkpoint was trained on."""
        if not self.fingerprint:
            return
        got = train_set.fingerprint()
        diffs = [f"{k}: checkpoint={self.fingerprint[k]!r} dataset={got[k]!r}"
                 for k in self.fingerprint
                 if k in got and got[k] != self.fingerprint[k]]
        if diffs:
            raise CheckpointError(
                "resume dataset does not match the checkpoint's training "
                "data (a resume against a different binned matrix cannot "
                "be bit-identical): " + "; ".join(diffs))

    def validate_config(self, cfg) -> None:
        """Structural params must match for the continuation to make
        sense (objective/num_class) or to stay bit-identical (seeds,
        sampling params) — the former fail, the latter warn."""
        p = self.params
        if not p:
            return
        for key in CKPT_STRUCTURAL_KEYS:
            if key in p and str(getattr(cfg, key)) != str(p[key]):
                raise CheckpointError(
                    f"cannot resume: checkpoint was trained with "
                    f"{key}={p[key]!r}, this run has "
                    f"{key}={getattr(cfg, key)!r}")
        from ..utils.random import rng_checkpoint_state
        now = rng_checkpoint_state(cfg)
        for key, val in self.rng_state.items():
            if key in now and int(now[key]) != int(val):
                raise CheckpointError(
                    f"cannot resume bit-identically: RNG seed {key} was "
                    f"{val} at checkpoint time but is {now[key]} now "
                    f"(utils/random.py streams are keyed on (seed, "
                    f"iteration); change the seed and the sampling "
                    f"trajectory forks)")
        drift = [f"{k}={p[k]!r}->{getattr(cfg, k)!r}" for k in CKPT_SOFT_KEYS
                 if k in p and str(getattr(cfg, k)) != str(p[k])]
        if drift:
            log_warning("resume config drifts from the checkpoint's "
                        "(continuation will not be bit-identical to an "
                        "uninterrupted run): " + ", ".join(drift))


def _ckpt_name(iteration: int) -> str:
    return f"ckpt_iter{iteration:08d}.npz"


class CheckpointManager:
    """Bounded ring of atomic snapshots in one directory.

    ``save()`` writes ``ckpt_iterNNNNNNNN.npz`` atomically, repoints
    ``LATEST``, then prunes beyond ``keep`` — in that order, so a crash
    between any two steps still leaves a loadable latest checkpoint.
    Thread-safe: the SIGTERM flush may race a periodic save."""

    def __init__(self, directory: str, keep: int = 3) -> None:
        self.directory = os.fspath(directory)
        self.keep = max(1, int(keep))
        self._lock = threading.Lock()
        self._write_seconds = default_registry().histogram(
            "checkpoint_write_seconds",
            "wall seconds per checkpoint bundle write")

    def save(self, ckpt: Checkpoint) -> str:
        import time
        t0 = time.perf_counter()
        with self._lock:
            os.makedirs(self.directory, exist_ok=True)
            name = _ckpt_name(ckpt.iteration)
            path = os.path.join(self.directory, name)
            atomic_write_bytes(path, ckpt.to_bytes())
            atomic_write_text(os.path.join(self.directory, LATEST), name)
            self._prune()
        self._write_seconds.observe(time.perf_counter() - t0)
        return path

    def _prune(self) -> None:
        for name, _ in self.list()[:-self.keep]:
            try:
                os.unlink(os.path.join(self.directory, name))
            except OSError:
                pass

    def list(self) -> List[tuple]:
        """(filename, iteration) pairs, oldest first."""
        try:
            entries = os.listdir(self.directory)
        except OSError:
            return []
        out = []
        for name in entries:
            m = _CKPT_RE.match(name)
            if m:
                out.append((name, int(m.group(1))))
        out.sort(key=lambda t: t[1])
        return out

    def latest_path(self) -> Optional[str]:
        """Resolve the newest loadable snapshot: the ``LATEST`` pointer
        when it names an existing file, else the highest-numbered ring
        entry (covers a crash between bundle write and repoint)."""
        try:
            with open(os.path.join(self.directory, LATEST)) as fh:
                name = fh.read().strip()
            if name and os.path.exists(os.path.join(self.directory, name)):
                return os.path.join(self.directory, name)
        except OSError:
            pass
        entries = self.list()
        if entries:
            return os.path.join(self.directory, entries[-1][0])
        return None


def load_checkpoint(path: str) -> Checkpoint:
    """Read one checkpoint bundle (a ``.npz`` file or a checkpoint
    directory, in which case the newest snapshot is used)."""
    resolved = resolve_checkpoint(path)
    if resolved is None:
        raise CheckpointError(f"no checkpoint found at {path!r}")
    try:
        with open(resolved, "rb") as fh:
            data = fh.read()
    except OSError as exc:
        raise CheckpointError(f"cannot read checkpoint {resolved}: {exc}") \
            from exc
    return Checkpoint.from_bytes(data, source=resolved)


def resolve_checkpoint(path: str) -> Optional[str]:
    """Map a user-supplied resume target (bundle file or checkpoint
    directory) to a concrete bundle path, or None."""
    path = os.fspath(path)
    if os.path.isdir(path):
        return CheckpointManager(path).latest_path()
    return path if os.path.exists(path) else None


# -- preemption handling -----------------------------------------------------
class PreemptionGuard:
    """SIGTERM/SIGINT handler installed for the duration of a training
    run (preemption notices arrive as SIGTERM): the handler only
    sets a flag; the boosting loop drains the in-flight iteration,
    flushes one final checkpoint, and exits via
    :class:`TrainingPreempted`.  On ``__exit__`` the previous handlers
    are restored.  Off the main thread (where ``signal.signal`` is
    illegal) the guard is inert."""

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self, enabled: bool = True) -> None:
        self._enabled = enabled and \
            threading.current_thread() is threading.main_thread()
        self._previous: Dict[int, Any] = {}
        self.fired: Optional[int] = None

    def __enter__(self) -> "PreemptionGuard":
        if not self._enabled:
            return self

        def _handler(signum, frame):
            if self.fired is not None:
                # second signal: the sender insists — restore the
                # previous dispositions and let this one take effect
                # immediately instead of waiting out a long iteration
                self.__exit__()
                os.kill(os.getpid(), signum)
                return
            log_warning(f"received {signal.Signals(signum).name}: "
                        "draining the current iteration, then "
                        "flushing a final checkpoint (repeat to abort "
                        "without the flush)")
            self.fired = signum

        for sig in self.SIGNALS:
            try:
                self._previous[sig] = signal.signal(sig, _handler)
            except (ValueError, OSError):  # non-main thread race / platform
                pass
        return self

    def __exit__(self, *exc) -> None:
        for sig, prev in self._previous.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
        self._previous.clear()
