"""Season formats: how a configuration's episodes are written, and what the
analyzer's route reads of each, one module a format.

A configuration's `format` names `formats/<format>.py` in the cell's
folder, found by file name as the metric readers are, so a new format is a
new file and a new configuration. The module gives:

  EXT        the episode file's extension
  SPEC_KEYS  the configuration's keys beyond run.SEASON_KEYS that `write`
             reads; they join the season's spec, and so its marker
  write(path, pcm, spec)
             writes one episode from the season's seeded mono int16
             samples at spec["rate"]
  windows(path, cfg)
             what the analyzer's route reads of one episode:
             (stream_ns, opening, ending, seek_ns), each window
             (interleaved int16 samples, n_valid, rate, channels)

The season writer and the reference run in `spawn` worker processes: they
are handed the module's path and load it there (`load`). A format module
imports nothing of the port.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

HERE = Path(__file__).resolve().parent


def find(name: str, folder=HERE) -> Path:
    """The path of format `name`'s module in `folder`; stops the run, before
    anything is written, where there is none."""
    path = Path(folder) / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"needle_bench: no season format {name!r}: "
                         f"{path.name} is not in {Path(folder)}")
    return path


def load(path):
    """The format module at `path`."""
    path = Path(path)
    spec = importlib.util.spec_from_file_location(f"needle_bench.formats.{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
