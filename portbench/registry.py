"""Where the benchmark finds what it runs, by the names ``BENCHMARK.json``
gives: a configuration in ``configs/<name>.json``, a cell in
``cells/<name>.json``, a per-layer metric's reader in
``metrics/<name>.py`` (or, where there is none, in the file of the name's
part before its first dot: ``idle_share.kg`` and ``idle_share.rxn`` share
``metrics/idle_share.py``) and the module of a configuration's family in
``families/<family>.py``.  Which cells report a per-layer metric follows
from the end-to-end metric it ``moves`` in ``BENCHMARK.json``.  A later
cell, configuration or metric is added as files and entries; nothing here
names one."""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, Optional

ROOT = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


class Registry:
    def __init__(self, root: Path = ROOT, benchmark: Optional[Path] = None):
        self.root = Path(root)
        self.benchmark = Path(benchmark) if benchmark else ROOT.parent / "BENCHMARK.json"
        self._modules: Dict[Path, ModuleType] = {}

    def _path(self, kind: str, name: str, suffix: str) -> Path:
        if not NAME.match(name):
            raise ValueError(f"not a name: {name!r}")
        path = self.root / kind / f"{name}{suffix}"
        if not path.is_file():
            raise KeyError(f"no {kind[:-1]} named {name!r} ({path})")
        return path

    def _json(self, kind: str, name: str) -> dict:
        with open(self._path(kind, name, ".json")) as f:
            return json.load(f)

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def cell(self, name: str) -> dict:
        return self._json("cells", name)

    def _module(self, path: Path) -> ModuleType:
        mod = self._modules.get(path)
        if mod is None:
            spec = importlib.util.spec_from_file_location(
                f"portbench_{path.parent.name}_{path.stem.replace('.', '_').replace('-', '_')}",
                path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._modules[path] = mod
        return mod

    def metric(self, name: str) -> ModuleType:
        """The reader of a per-layer metric: its module has ``UNIT`` and
        ``read(ctx)``, which returns the value, or None where it finds
        nothing to read."""
        stem = name.split(".")[0]
        if stem != name and not (self.root / "metrics" / f"{name}.py").is_file():
            name = stem
        return self._module(self._path("metrics", name, ".py"))

    def family(self, name: str) -> ModuleType:
        """The module of a family of configurations, which has
        ``Workload`` (see ``families/sparse.py``)."""
        return self._module(self._path("families", name, ".py"))

    def per_layer(self) -> Dict[str, str]:
        """{per-layer metric: the end-to-end metric it moves}, from
        ``BENCHMARK.json``."""
        with open(self.benchmark) as f:
            return {m["name"]: m["moves"] for m in json.load(f)["per_layer"]}
