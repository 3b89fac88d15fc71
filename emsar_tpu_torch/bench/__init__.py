"""Benchmarks of the port's kernels on the card, and what they share with
``chip_smoke.py``: the smoke sample, the scale transcriptome, another
checkout loaded beside this one, and the parent/change order."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys

import numpy as np

ORDER = ("parent", "change", "change", "parent")

# The scale transcriptome (tools/make_scale_fixture.py's, ~338 Mbp) and the
# read length of its SE build.
SCALE_GENES = 42000
SCALE_SEED = 20260820
SCALE_READLEN = 76


def load_parent(root: str, *names: str):
    """Modules ``names`` (relative to the package, e.g. "kernels.squarem")
    of another checkout's ``emsar_tpu_torch``, rooted at ``root`` and
    loaded under the name ``parent_port``, so that it builds its own
    kernels into its own ``_build/``."""
    pkg = os.path.join(root, "emsar_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "parent_port", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["parent_port"] = mod
    spec.loader.exec_module(mod)
    return tuple(importlib.import_module(f"parent_port.{n}") for n in names)


def smoke_sample(rsh: str, aln: str):
    """``quantify.prepare_sample`` of the smoke fixture (``rsh``, bowtie
    alignments ``aln``) through the native collapser."""
    from ..config import QuantConfig
    from ..ingest import native
    from ..io.rsh import RshIndex
    from ..model import quantify

    index = RshIndex.load(rsh)
    cfg = QuantConfig(verbose=0, min_fraglength=index.min_fraglength,
                      max_fraglength=index.max_fraglength)
    counts = native.NativeCollapser(index).collapse_file(
        aln, "bowtie", False, 0, cfg.max_repeat, cfg.min_fraglength,
        cfg.max_fraglength)
    return quantify.prepare_sample(index, counts, cfg)


def scale_transcriptome():
    """(names, seqs) of the scale transcriptome."""
    from ..sim import gene_family_transcriptome

    names, seqs, _ = gene_family_transcriptome(
        np.random.default_rng(SCALE_SEED), SCALE_GENES, min_isoforms=2,
        max_isoforms=6, n_exons=10, min_exon=120, max_exon=500)
    return names, seqs


def write_result(out: dict, path: str) -> None:
    """Print ``out`` as one JSON line and write it to ``path``."""
    text = json.dumps(out)
    print(text)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fh:
        fh.write(text + "\n")
