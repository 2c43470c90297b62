"""Run a function on a group of ranks, one process each.

The JAX package simulates its devices in one process
(`tests/conftest.py:17`); the port's ranks are OS processes.
`run_ranks(fn, world, device=..., timeout=...)` starts `world` Python
processes, each of which joins one `torch.distributed` process group and
calls `fn(*args, **kwargs)`, and returns every rank's result in rank
order.

- The ranks meet through a FileStore in a fresh temporary directory
  (`init_method="file://<dir>/store"`), never a fixed TCP port, so two
  launches never meet each other's ranks.
- The process group has a timeout (`PG_TIMEOUT_S`, 60 s): a rank left
  waiting on a peer that died raises instead of waiting for ever.
- The caller waits at most `timeout` seconds. Past it every rank is
  killed and `TimeoutError` is raised; the first rank that fails has its
  exception raised in the caller, with its traceback, after the others
  are killed.
- A rank imports this module and the module of `fn`, with `jax` and
  `gridapsolvers_tpu` blocked: `fn` lives in this package or in a
  torch-only module. Its arguments and result travel by pickle, so they
  are NumPy arrays, tensors (results are moved to the host) and plain
  values.

A CPU rank runs torch on its share of the host's cores (the core count
over the rank count), unless the caller's environment sets
OMP_NUM_THREADS, which the ranks inherit and follow. The ranks run on
the card unless the caller passes `device="cpu"` (`device=None` is
"cuda", and raises where there is none). Backend: NCCL where each rank
has a GPU of its own, gloo otherwise (the CPU, or more ranks than GPUs;
`mesh.ProcessMesh` then stages the messages of CUDA blocks through host
buffers). `rank_device()` gives the device of the calling rank.

Run a rank by hand: `python -m gridapsolvers_tpu_torch.parallel.launch
SPEC RANK`, where SPEC is the pickle `run_ranks` writes.
"""
from __future__ import annotations

import datetime
import importlib
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

_PKG_PARENT = Path(__file__).resolve().parents[2]
PG_TIMEOUT_S = 60.0
_DEVICE = None


def rank_device():
    """The device `run_ranks` gave this rank; outside a launch, the card
    (`utils.resolve_device`: raises where there is none)."""
    import torch

    from ..utils import resolve_device

    return torch.device(_DEVICE) if _DEVICE else resolve_device(None)


class RankError(RuntimeError):
    """A rank's exception that could not travel back as itself."""


def _to_host(v):
    import torch

    if isinstance(v, torch.Tensor):
        return v.detach().cpu()
    if isinstance(v, dict):
        return {k: _to_host(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_to_host(x) for x in v)
    return v


def _choose_backend(device: str, world: int) -> str:
    if not device.startswith("cuda"):
        return "gloo"
    import torch

    return "nccl" if world <= torch.cuda.device_count() else "gloo"


class RankLaunch:
    """A running launch: `result()` waits for it (see `run_ranks`)."""

    def __init__(self, fn, world: int, args=(), kwargs=None, *, device=None,
                 timeout: float = 120.0):
        from ..utils import resolve_device

        device = str(resolve_device(device))
        self.world, self.timeout = int(world), float(timeout)
        self.dir = Path(tempfile.mkdtemp(prefix="ranks-"))
        spec = {
            "module": fn.__module__, "qualname": fn.__qualname__,
            "module_dir": str(Path(sys.modules[fn.__module__].__file__).resolve().parent),
            "args": tuple(args), "kwargs": dict(kwargs or {}), "world": self.world,
            "device": device, "backend": _choose_backend(device, self.world),
            "store": str(self.dir / "store"),
        }
        spec_path = self.dir / "spec.pkl"
        spec_path.write_bytes(pickle.dumps(spec))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(_PKG_PARENT)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
        self.procs = []
        self.logs = []
        for r in range(self.world):
            log = open(self.dir / f"rank{r}.log", "wb")
            self.logs.append(log)
            self.procs.append(subprocess.Popen(
                [sys.executable, "-m", __name__, str(spec_path), str(r)],
                stdout=log, stderr=subprocess.STDOUT, env=env))
        self.t0 = time.monotonic()

    def _kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()
        for log in self.logs:
            log.close()

    def _log(self, r: int) -> str:
        text = (self.dir / f"rank{r}.log").read_text(errors="replace")
        return text[-4000:]

    def result(self) -> list:
        try:
            while True:
                codes = [p.poll() for p in self.procs]
                failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if failed:
                    self._kill()
                    self._raise(failed)
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() - self.t0 > self.timeout:
                    self._kill()
                    raise TimeoutError(
                        f"{self.world} ranks still running after {self.timeout:.0f} s; all "
                        f"killed. Rank 0's log:\n{self._log(0)}")
                time.sleep(0.02)
            for log in self.logs:
                log.close()
            out = []
            for r in range(self.world):
                _, value = pickle.loads((self.dir / f"result{r}.pkl").read_bytes())
                out.append(value)
            return out
        finally:
            self._kill()
            shutil.rmtree(self.dir, ignore_errors=True)

    def _raise(self, failed) -> None:
        # the first rank to fail: the one whose error file is oldest
        errs = [(r, self.dir / f"result{r}.pkl") for r in failed]
        errs = [(p.stat().st_mtime, r, p) for r, p in errs if p.exists()]
        if not errs:
            r = failed[0]
            raise RankError(f"rank {r} exited with code {self.procs[r].returncode}:\n"
                            f"{self._log(r)}")
        _, r, path = min(errs)
        _, (exc, tb) = pickle.loads(path.read_bytes())
        note = f"raised on rank {r} of {self.world}:\n{tb}"
        if isinstance(exc, BaseException):
            exc.add_note(note)
            raise exc
        raise RankError(f"{exc}\n{note}")


def launch_ranks(fn, world: int, args=(), kwargs=None, **kw) -> RankLaunch:
    """Start `run_ranks` and return at once; `.result()` waits."""
    return RankLaunch(fn, world, args, kwargs, **kw)


def run_ranks(fn, world: int, args=(), kwargs=None, *, device=None,
              timeout: float = 120.0) -> list:
    """fn(*args, **kwargs) on `world` ranks; their results in rank order
    (module docstring). `device` is "cuda" (the default; rank r gets
    cuda:(r mod the GPU count)) or "cpu"."""
    return RankLaunch(fn, world, args, kwargs, device=device, timeout=timeout).result()


def _child(spec_path: str, rank: int) -> None:
    sys.modules["jax"] = None
    sys.modules["gridapsolvers_tpu"] = None
    spec = pickle.loads(Path(spec_path).read_bytes())
    out = Path(spec["store"]).parent / f"result{rank}.pkl"
    try:
        import torch
        import torch.distributed as dist

        device = spec["device"]
        if device.startswith("cuda"):
            device = f"cuda:{rank % torch.cuda.device_count()}"
            torch.cuda.set_device(device)
        elif "OMP_NUM_THREADS" not in os.environ:
            # ranks share the host's cores: spinning intra-op threads of
            # one rank would starve the others at every collective
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // spec["world"]))
        # this file runs as __main__: set the device where importers read it
        importlib.import_module("gridapsolvers_tpu_torch.parallel.launch")._DEVICE = device
        dist.init_process_group(
            spec["backend"], init_method=f"file://{spec['store']}", rank=rank,
            world_size=spec["world"], timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
        try:
            try:
                mod = importlib.import_module(spec["module"])
            except ImportError:
                sys.path.insert(0, spec["module_dir"])
                mod = importlib.import_module(spec["module"])
            fn = mod
            for part in spec["qualname"].split("."):
                fn = getattr(fn, part)
            value = _to_host(fn(*spec["args"], **spec["kwargs"]))
        finally:
            dist.destroy_process_group()
        payload = ("ok", value)
    except BaseException as exc:  # noqa: BLE001 - everything goes back to the caller
        tb = traceback.format_exc()
        try:
            pickle.dumps(exc)
            payload = ("err", (exc, tb))
        except Exception:  # noqa: BLE001
            payload = ("err", (repr(exc), tb))
        tmp = out.with_suffix(".tmp")
        tmp.write_bytes(pickle.dumps(payload))
        os.replace(tmp, out)
        sys.stderr.write(tb)
        sys.exit(1)
    tmp = out.with_suffix(".tmp")
    tmp.write_bytes(pickle.dumps(payload))
    os.replace(tmp, out)


if __name__ == "__main__":
    _child(sys.argv[1], int(sys.argv[2]))
