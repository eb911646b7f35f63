"""Checkpoint and resume: the trainer's batch cursor and its model and
optimizer state.

Every epoch's shuffle derives from ``(seed, epoch)``, so after a
preemption the same batch stream comes back by shuffling the epoch again
and skipping the batches already trained
(``set_epoch(epoch, skip_batches=cursor.batches_yielded)``). The model's
and the optimizer's ``state_dict`` complete the resume.

Layout on disk, one directory per checkpoint, published atomically::

    <dir>/ckpt-0000000042/
        cursor.json   # BatchCursor: epoch, batches_yielded, step, config
        state.pt      # torch.save({"model": ..., "optimizer": ...}) (optional)
    <dir>/ckpt-0000000042.tmp-*   # a save in flight: never read

``cursor.json`` has the JAX package's schema (its ``checkpoint.py``): a
cursor written by either package restores and validates in the other.

One process writes (rank 0 of an initialized ``torch.distributed``
group); the others get the path back. A save staged under a ``.tmp-``
name whose writer died is never surfaced and is pruned once older than
``_DEBRIS_GRACE_S``.

When the shuffle's journal is armed (``RSDL_JOURNAL``,
:mod:`.runtime.journal`), ``save`` stamps the cursor with the journal's
run id, so that a trainer cursor and the driver's window can be joined.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import sys
import tempfile
import time
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Tuple

_CKPT_RE = re.compile(r"^ckpt-(\d{10})$")
# A staging directory whose writer died before its rename.
_DEBRIS_RE = re.compile(r"^ckpt-\d{10}\.tmp-")
# Only debris older than this is pruned: with one writer per directory
# an old one is a dead writer's, a young one may be a save in flight.
_DEBRIS_GRACE_S = 300.0
STATE_FILE = "state.pt"


@dataclass
class BatchCursor:
    """A position in the shuffled batch stream.

    ``batches_yielded`` counts the batches this rank yielded within
    ``epoch``; a resume passes it to ``set_epoch(epoch,
    skip_batches=batches_yielded)``. ``config`` is the stream's identity
    (:meth:`stream_config`): resuming under another seed, batch size or
    topology would deliver another stream, so :meth:`validate` refuses.
    ``run_id``: the shuffle journal's run this cursor was taken under
    (informational; a resumed driver gets a new one)."""

    epoch: int = 0
    batches_yielded: int = 0
    step: int = 0
    config: Dict[str, Any] = field(default_factory=dict)
    run_id: Optional[str] = None

    @staticmethod
    def stream_config(
        *,
        seed: int,
        batch_size: int,
        num_trainers: int,
        num_reducers: int,
        num_files: int,
        drop_last: bool,
        plan: Optional[str] = None,
    ) -> Dict[str, Any]:
        """The stream-identity knobs. ``plan``: the resolved shuffle-plan
        label (``rowwise`` or ``block:G``); None reads this process's
        ``RSDL_SHUFFLE_PLAN``, and a value that does not parse is recorded
        as ``unknown``."""
        if plan is None:
            from ray_shuffling_data_loader_tpu_torch.shuffle import shuffle_plan_label

            try:
                plan = shuffle_plan_label()
            except ValueError:
                plan = "unknown"
        return {
            "seed": seed,
            "batch_size": batch_size,
            "num_trainers": num_trainers,
            "num_reducers": num_reducers,
            "num_files": num_files,
            "drop_last": drop_last,
            "plan": plan,
        }

    def validate(self, config: Dict[str, Any]) -> None:
        """Raise ``ValueError`` when ``config`` names another stream. A
        side without a ``plan`` key (cursors from before the plan family)
        counts as ``rowwise``."""
        mine, theirs = dict(self.config), dict(config)
        if mine and theirs:
            mine.setdefault("plan", "rowwise")
            theirs.setdefault("plan", "rowwise")
        if mine and theirs and mine != theirs:
            diff = {k: (mine.get(k), theirs.get(k)) for k in set(mine) | set(theirs) if mine.get(k) != theirs.get(k)}
            raise ValueError(
                "checkpoint cursor was written under a different shuffle configuration; "
                f"resuming would change the batch stream: {diff}"
            )


class CheckpointManager:
    """Step-numbered checkpoints with atomic publish and retention.

    Args:
        directory: the checkpoint root (made at the first save).
        max_to_keep: keep this many newest checkpoints (None: all).
    """

    def __init__(self, directory: str, max_to_keep: Optional[int] = 3):
        self.directory = directory
        self.max_to_keep = max_to_keep

    # -- write -------------------------------------------------------------------

    def save(self, step: int, cursor: Optional[BatchCursor] = None, state: Any = None) -> str:
        """Write one checkpoint; returns its directory.

        ``state``: what ``torch.save`` writes, typically ``{"model":
        model.state_dict(), "optimizer": optimizer.state_dict()}``; its
        tensors are copied to the host first. The directory is staged
        under a ``.tmp-`` name, its files and itself fsynced, and renamed
        into place, so a preemption mid-save never leaves a checkpoint
        that reads half. In a ``torch.distributed`` run every rank may
        call it: the state is replicated, rank 0 writes, the others
        return the path."""
        final = os.path.join(self.directory, f"ckpt-{step:010d}")
        if _process_index() != 0:
            return final
        host_state = None if state is None else _to_host(state)
        os.makedirs(self.directory, exist_ok=True)
        tmp = tempfile.mkdtemp(prefix=f"ckpt-{step:010d}.tmp-", dir=self.directory)
        try:
            if cursor is not None:
                cursor.step = step
                if cursor.run_id is None:
                    cursor.run_id = _journal_run_id()
                with open(os.path.join(tmp, "cursor.json"), "w") as f:
                    json.dump(asdict(cursor), f, indent=2)
                    f.flush()
                    os.fsync(f.fileno())
            if host_state is not None:
                import torch

                with open(os.path.join(tmp, STATE_FILE), "wb") as f:
                    torch.save(host_state, f)
                    f.flush()
                    os.fsync(f.fileno())
            os.chmod(tmp, 0o755)  # mkdtemp makes 0o700
            self._fsync_dir(tmp)
            if os.path.isdir(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._fsync_dir(self.directory)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._prune()
        return final

    @staticmethod
    def _fsync_dir(path: str) -> None:
        try:
            fd = os.open(path, os.O_RDONLY)
        except OSError:
            return
        try:
            os.fsync(fd)
        except OSError:
            pass
        finally:
            os.close(fd)

    def _prune(self) -> None:
        if self.max_to_keep is None:
            return
        for step in self.all_steps()[: -self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, f"ckpt-{step:010d}"), ignore_errors=True)

    # -- read ---------------------------------------------------------------------

    def all_steps(self) -> List[int]:
        """Published steps, sorted. Staging debris is never surfaced, and
        debris past the grace window is pruned on the way."""
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return []
        steps = []
        for name in names:
            m = _CKPT_RE.match(name)
            if m:
                steps.append(int(m.group(1)))
            elif _DEBRIS_RE.match(name):
                self._prune_debris(name)
        return sorted(steps)

    def _prune_debris(self, name: str) -> None:
        path = os.path.join(self.directory, name)
        try:
            if time.time() - os.path.getmtime(path) < _DEBRIS_GRACE_S:
                return
        except OSError:
            return
        shutil.rmtree(path, ignore_errors=True)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _path(self, step: int, name: str) -> str:
        return os.path.join(self.directory, f"ckpt-{step:010d}", name)

    def restore_cursor(self, step: Optional[int] = None) -> Optional[BatchCursor]:
        """The cursor of ``step`` (default: the newest), or None when there
        is no checkpoint or it has no cursor."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        try:
            with open(self._path(step, "cursor.json")) as f:
                raw = json.load(f)
        except FileNotFoundError:
            return None
        return BatchCursor(**raw)

    def restore_state(self, step: Optional[int] = None, device=None) -> Optional[Dict[str, Any]]:
        """The saved state of ``step`` (default: the newest) with its
        tensors on ``device`` (default: the CPU), or None when there is no
        checkpoint or it holds no state. A state file that does not load
        raises."""
        import torch

        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        path = self._path(step, STATE_FILE)
        if not os.path.exists(path):
            return None
        return torch.load(path, map_location=device if device is not None else "cpu", weights_only=True)

    def restore(
        self,
        target: Optional[Mapping[str, Any]] = None,
        step: Optional[int] = None,
        device=None,
        in_place: bool = False,
    ) -> Tuple[Optional[Any], Optional[BatchCursor]]:
        """``(state, cursor)`` of ``step`` (default: the newest);
        ``(None, None)`` when there is no checkpoint.

        With ``target``, a mapping like the saved state's whose values are
        a module and an optimizer (``{"model": model, "optimizer": opt}``),
        each loads its saved ``state_dict`` and ``target`` comes back as
        the state. ``in_place``: copy into the tensors they already hold
        instead of swapping them, for a model and optimizer that a CUDA
        graph has captured (the optimizer must have its state already).
        A checkpoint without state, or with state that does not fit the
        target, raises."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        cursor = self.restore_cursor(step)
        state = self.restore_state(step, device=device)
        if target is None:
            return state, cursor
        if state is None:
            raise FileNotFoundError(f"checkpoint {step} in {self.directory!r} holds no {STATE_FILE}")
        missing = set(target) - set(state)
        if missing:
            raise KeyError(f"checkpoint {step} has no state for {sorted(missing)}")
        for name, obj in target.items():
            (_load_in_place if in_place else _load)(obj, state[name])
        return target, cursor


def _load(obj, saved) -> None:
    obj.load_state_dict(saved)


def _load_in_place(obj, saved) -> None:
    """Copy ``saved`` into the tensors ``obj`` holds (a module's
    parameters and buffers, an optimizer's state), keeping their
    identity; the optimizer's hyperparameters are set from ``saved``."""
    import torch

    current = obj.state_dict()
    if "param_groups" not in current:  # a module
        missing = set(current) ^ set(saved)
        if missing:
            raise KeyError(f"state_dict keys differ: {sorted(missing)}")
        with torch.no_grad():
            for key, tensor in current.items():
                tensor.copy_(saved[key])
        return
    if set(current["state"]) != set(saved["state"]):
        raise ValueError("in-place restore needs the optimizer's state made first (a step, or the fused epoch's capture)")
    with torch.no_grad():
        for pid, entries in saved["state"].items():
            for key, value in entries.items():
                current["state"][pid][key].copy_(value)
    if len(obj.param_groups) != len(saved["param_groups"]):
        raise ValueError("the optimizer's parameter groups differ from the checkpoint's")
    for group, saved_group in zip(obj.param_groups, saved["param_groups"]):
        for key, value in saved_group.items():
            if key != "params":
                if isinstance(group.get(key), torch.Tensor):
                    group[key].copy_(value)
                else:
                    group[key] = value


def _journal_run_id() -> Optional[str]:
    """The journal run in flight, read only when the shuffle already
    imported the journal (a run without ``RSDL_JOURNAL`` never loads it)."""
    jmod = sys.modules.get("ray_shuffling_data_loader_tpu_torch.runtime.journal")
    return jmod.current_run_id() if jmod is not None else None


def _process_index() -> int:
    """This process's rank in an initialized ``torch.distributed`` group,
    else 0; ``torch.distributed`` is read only when already imported."""
    dist = sys.modules.get("torch.distributed")
    if dist is None or not dist.is_available() or not dist.is_initialized():
        return 0
    return dist.get_rank()


def _to_host(tree):
    """``tree`` with every tensor detached and copied to the host. The
    port's state is replicated over its ranks, so no gather is needed."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, Mapping):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree
