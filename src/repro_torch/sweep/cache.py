"""On-disk content-addressed cache of completed scenario records
(counterpart of ``repro.sweep.cache``).

Keyed by ``Scenario.key`` (sha256 of the full config tree + runner
knobs + schema version, see ``grid.config_digest``), so a cache entry
is valid exactly as long as the scenario it describes is byte-identical.
Layout: ``<root>/<device type>/<key[:2]>/<key>.json`` — one JSON record
per scenario, under the type of the torch device that computed it
(``cuda`` or ``cpu``), so a run on the card is never served records the
host made, nor the other way round. The keys are the reference's, so the
default root is the port's own (``results/torch/sweep_cache``, or
``$REPRO_TORCH_SWEEP_CACHE``), never the reference's.
Writes are atomic (tmp file + rename) so parallel workers and
interrupted runs never leave a torn entry behind.

Reads and writes are additionally memoized in-process (bounded LRU):
repeated sweeps over overlapping grids in one process — the benchmark
harness, notebook loops, long-lived remote workers — skip the
open+parse per hit, and eviction drops the least-recently-touched
entry so hot keys stay resident past the cap. The on-disk entry stays
authoritative; the memo only ever holds records this process itself
read or wrote.
"""
from __future__ import annotations

import json
import os
import tempfile
from collections import OrderedDict
from pathlib import Path
from typing import Iterator, Optional

from repro_torch.device import DeviceLike, resolve_device

ENV_CACHE_DIR = "REPRO_TORCH_SWEEP_CACHE"
DEFAULT_CACHE_DIR = Path("results") / "torch" / "sweep_cache"


def default_cache_root() -> Path:
    return Path(os.environ.get(ENV_CACHE_DIR, DEFAULT_CACHE_DIR))


class ResultCache:
    _MEMO_CAP = 65536       # bound in-process memory, not correctness

    def __init__(self, root: Optional[Path] = None,
                 torch_device: DeviceLike = None):
        """``root`` (default ``default_cache_root()``) holds one
        subdirectory per torch device type; this cache reads and writes
        that of ``torch_device`` (``None``: the card, raising without
        one)."""
        self.device_type = resolve_device(torch_device).type
        base = Path(root) if root is not None else default_cache_root()
        self.root = base / self.device_type
        self._memo: OrderedDict = OrderedDict()
        # cumulative effectiveness counters (process lifetime): hits
        # served from the in-process memo vs parsed off disk vs misses.
        # The sweep runner snapshots deltas per run for its summary.
        self.counters = {"memo": 0, "disk": 0, "miss": 0}

    def path_for(self, key: str) -> Path:
        return self.root / key[:2] / f"{key}.json"

    def get(self, key: str) -> Optional[dict]:
        memo = self._memo.get(key)
        if memo is not None:
            self._memo.move_to_end(key)
            self.counters["memo"] += 1
            return memo
        path = self.path_for(key)
        try:
            with open(path) as f:
                record = json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            self.counters["miss"] += 1
            return None
        if record.get("key") != key:        # corrupt/foreign entry
            self.counters["miss"] += 1
            return None
        self._remember(key, record)
        self.counters["disk"] += 1
        return record

    def _remember(self, key: str, record: dict) -> None:
        if key in self._memo:
            self._memo.move_to_end(key)
        elif len(self._memo) >= self._MEMO_CAP:
            self._memo.popitem(last=False)   # evict least-recently-used
        self._memo[key] = record

    def put(self, key: str, record: dict) -> Path:
        path = self.path_for(key)
        path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(record, f, default=str)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self._remember(key, record)
        return path

    def iter_keys(self) -> Iterator[str]:
        if not self.root.exists():
            return
        for sub in sorted(self.root.iterdir()):
            if sub.is_dir():
                for entry in sorted(sub.glob("*.json")):
                    yield entry.stem

    def __len__(self) -> int:
        return sum(1 for _ in self.iter_keys())

    def clear(self) -> int:
        self._memo.clear()
        n = 0
        for key in list(self.iter_keys()):
            self.path_for(key).unlink(missing_ok=True)
            n += 1
        return n
