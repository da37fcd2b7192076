"""Fault-tolerant checkpointing — the port of the JAX package's
``checkpoint/checkpoint.py``, in its on-disk format, so a checkpoint written
by either package restores in the other.

Behaviours kept:
  * atomic commits — write to ``<dir>/tmp.<step>.<pid>`` then ``os.rename``;
    re-saving an existing step renames the committed dir aside
    (``step_X.old``) rather than deleting it first, and ``_recover`` rolls a
    half-commit back on the next start;
  * one ``.npy`` per leaf, keyed by the JAX train state's leaf paths, and a
    ``manifest.json`` with each leaf's shape, logical dtype and adler32
    checksum, verified on load; bfloat16 leaves are stored as their raw
    ``uint16`` bits (numpy has no bfloat16);
  * ``restore_latest_good`` — walk newest→oldest, verify checksums and the
    manifest's health stamp, quarantine corrupt dirs to ``corrupt.<step>``
    and fall back to the previous step;
  * keep-last-N garbage collection that never rotates out the newest
    checkpoint stamped healthy;
  * async saves on a writer thread, joined by the next save.

The port updates parameters in place, so ``save`` takes a flat dict of CPU
tensors whose device→host copies have already finished
(``jax_bridge.train_state_to_host``); only the file writing is async.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import signal
import threading
import zlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.jax_bridge import check_against_spec

_BF16 = "bfloat16"


def _checksum(a: np.ndarray) -> int:
    return zlib.adler32(np.ascontiguousarray(a).view(np.uint8).data)


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(the array as stored, its logical dtype name)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), _BF16
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == _BF16:
        if arr.dtype != np.uint16:
            raise ValueError(f"bf16 leaf stored as {arr.dtype}, expected uint16")
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


class CheckpointManager:
    def __init__(self, directory: str, keep_last_n: int = 3,
                 async_save: bool = False):
        self.directory = directory
        self.keep_last_n = keep_last_n
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._async_exc: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)
        self._recover()

    def _recover(self) -> None:
        """Roll back half-finished commits from a crashed writer: stale
        ``tmp.*`` dirs are uncommitted (drop them); a ``step_X.old`` with no
        ``step_X`` means the crash hit between the two commit renames — the
        aside copy IS the committed checkpoint, so rename it back."""
        for name in sorted(os.listdir(self.directory)):
            path = os.path.join(self.directory, name)
            if name.startswith("tmp."):
                shutil.rmtree(path, ignore_errors=True)
            elif name.endswith(".old"):
                final = path[: -len(".old")]
                if os.path.exists(final):
                    shutil.rmtree(path, ignore_errors=True)
                else:
                    os.rename(path, final)

    # ------------------------------ save --------------------------------
    def save(self, step: int, flat: Dict[str, torch.Tensor], extra: Optional[Dict] = None,
             topology: Optional[Dict] = None) -> str:
        """Write ``flat`` (path → CPU tensor) as ``step_<step>``. With
        ``async_save`` the files are written on a writer thread; the tensors
        must not change meanwhile (``train_state_to_host`` gives copies)."""
        self.wait()                               # one in-flight save max
        arrays = {k: _to_numpy(t) for k, t in flat.items()}
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write_guarded, args=(step, arrays, extra or {}, topology),
                daemon=False)
            self._thread.start()
            return os.path.join(self.directory, f"step_{step:08d}")
        return self._write(step, arrays, extra or {}, topology)

    def _write_guarded(self, step, arrays, extra, topology=None) -> None:
        """Writer-thread wrapper: a dead writer must not pass silently —
        its exception is re-raised from the next :meth:`wait`."""
        try:
            self._write(step, arrays, extra, topology)
        except BaseException as e:          # noqa: BLE001 — surfaced later
            self._async_exc = e

    def _write(self, step: int, arrays: Dict[str, Tuple[np.ndarray, str]], extra: Dict,
               topology: Optional[Dict] = None) -> str:
        final = os.path.join(self.directory, f"step_{step:08d}")
        tmp = os.path.join(self.directory, f"tmp.{step}.{os.getpid()}")
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "extra": extra, "leaves": {}}
        if topology is not None:
            manifest["topology"] = topology
        for key, (arr, logical_dtype) in arrays.items():
            fname = re.sub(r"[^A-Za-z0-9_.-]", "_", key) + ".npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"][key] = {
                "file": fname, "shape": list(arr.shape), "dtype": logical_dtype,
                "adler32": _checksum(arr)}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            # bare NaN/Infinity literals are invalid JSON — callers sanitize
            # non-finite metrics (sanitize_row) before they reach a manifest
            json.dump(manifest, f, allow_nan=False)
        old = final + ".old"
        if os.path.exists(final):
            # re-saving an existing step: the committed dir is renamed
            # aside, not deleted, until the new one is in place
            os.rename(final, old)
        os.rename(tmp, final)                      # atomic commit
        if os.path.exists(old):
            shutil.rmtree(old)
        self._gc()
        return final

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._async_exc is not None:
            exc, self._async_exc = self._async_exc, None
            raise exc

    def _gc(self) -> None:
        if not self.keep_last_n:
            return
        steps = self.all_steps()
        keep = set(steps[-self.keep_last_n:])
        # never rotate out the newest step stamped healthy: rollback still
        # needs a good state to land on
        healthy = [s for s in steps if self._healthy(s)]
        if healthy:
            keep.add(healthy[-1])
        for s in steps:
            if s not in keep:
                shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                              ignore_errors=True)

    def _healthy(self, step: int) -> bool:
        """A checkpoint's manifest health stamp; unstamped checkpoints
        count as healthy."""
        try:
            health = self.manifest(step).get("extra", {}).get("health")
        except (OSError, ValueError):
            return False
        return True if health is None else bool(health.get("healthy", True))

    # ----------------------------- restore ------------------------------
    def all_steps(self):
        out = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d{8})", name)
            if m and os.path.exists(os.path.join(self.directory, name, "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, spec: Optional[Dict[str, Any]] = None,
                verify: bool = True) -> Dict[str, torch.Tensor]:
        """The leaves of ``step_<step>`` as CPU tensors (bf16 rebuilt from
        its bits). With ``spec`` (``jax_bridge.train_state_spec``) a leaf the
        state needs that is missing raises ``KeyError``, and a shape or
        dtype that differs ``ValueError``; checksums are verified
        (``IOError``) unless ``verify`` is false."""
        path = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        out = {}
        for key, meta in manifest["leaves"].items():
            arr = np.load(os.path.join(path, meta["file"]))
            if verify and _checksum(arr) != meta["adler32"]:
                raise IOError(f"checksum mismatch for '{key}' — corrupt checkpoint")
            if list(arr.shape) != list(meta["shape"]):
                raise ValueError(f"'{key}': file shape {arr.shape} != manifest {meta['shape']}")
            out[key] = _from_numpy(arr, meta["dtype"])
        if spec is not None:
            check_against_spec(out, spec)
        return out

    def restore_latest_good(self, spec: Optional[Dict[str, Any]] = None):
        """Restore the newest checkpoint that is intact (checksums verify,
        the leaves fit ``spec``) and stamped healthy, walking newest→oldest.
        Corrupt dirs are quarantined to ``corrupt.<step>``; unhealthy-stamped
        ones are skipped in place. Returns ``(step, flat, manifest)``; raises
        ``FileNotFoundError`` when no restorable checkpoint remains."""
        for step in reversed(self.all_steps()):
            try:
                manifest = self.manifest(step)
            except (OSError, ValueError):
                self._quarantine(step)
                continue
            health = manifest.get("extra", {}).get("health")
            if health is not None and not health.get("healthy", True):
                print(f"[ckpt] step {step} stamped unhealthy — skipping")
                continue
            try:
                flat = self.restore(step, spec, verify=True)
            except (OSError, ValueError, KeyError) as e:
                print(f"[ckpt] step {step} failed verification ({e}) — quarantining")
                self._quarantine(step)
                continue
            return step, flat, manifest
        raise FileNotFoundError(f"no healthy checkpoint under '{self.directory}'")

    def _quarantine(self, step: int) -> None:
        src = os.path.join(self.directory, f"step_{step:08d}")
        dst = os.path.join(self.directory, f"corrupt.{step:08d}")
        if os.path.exists(dst):
            shutil.rmtree(dst)
        os.rename(src, dst)

    def manifest(self, step: int) -> Dict:
        path = os.path.join(self.directory, f"step_{step:08d}", "manifest.json")
        with open(path) as f:
            return json.load(f)

    def latest_manifest(self) -> Optional[Dict]:
        step = self.latest_step()
        return None if step is None else self.manifest(step)


def load_experiment(directory: str):
    """The ``ExperimentConfig`` embedded in the latest manifest of
    ``directory``: the resume path needs no re-specified flags. Raises if
    the directory has no checkpoint or its manifest embeds no config."""
    from repro_torch.api.config import ExperimentConfig  # lazy: api imports checkpoint
    manifest = CheckpointManager(directory).latest_manifest()
    if manifest is None:
        raise FileNotFoundError(f"no checkpoint under '{directory}'")
    exp = manifest.get("extra", {}).get("experiment")
    if exp is None:
        raise KeyError(f"checkpoint in '{directory}' has no embedded experiment config")
    return ExperimentConfig.from_dict(exp)


class EmergencySaver:
    """SIGTERM/SIGINT preemption handler: request a final checkpoint."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.should_stop = False
        self._prev = {}
        for sig in signals:
            try:
                self._prev[sig] = signal.signal(sig, self._handler)
            except (ValueError, OSError):       # non-main thread
                pass

    def _handler(self, signum, frame):
        self.should_stop = True

    def restore_handlers(self):
        """Unwind the installed handlers (idempotent)."""
        prev, self._prev = self._prev, {}
        for sig, handler in prev.items():
            signal.signal(sig, handler)
