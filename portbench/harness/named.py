"""Files found by the name that `BENCHMARK.json` or a mix file gives:
`portbench/<folder>/<name>.py` (a metric's reader, an arrival law, a
serving entry point). A later change adds such a file and edits none."""
from __future__ import annotations

import importlib.util
import os
import sys

PORTBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_loaded: dict = {}


def load(folder: str, name: str):
    """The module `portbench/<folder>/<name>.py`, loaded once a process."""
    key = (folder, name)
    if key not in _loaded:
        path = os.path.join(PORTBENCH, folder, f"{name}.py")
        if not os.path.exists(path):
            raise ValueError(f"no {name!r} in portbench/{folder}/")
        module = f"portbench_{folder}_{name.replace('.', '_').replace('-', '_')}"
        spec = importlib.util.spec_from_file_location(module, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[module] = mod     # a dataclass in the file looks its module up
        spec.loader.exec_module(mod)
        _loaded[key] = mod
    return _loaded[key]
