"""The multisample workload's input: an alignment file split by read name
into samples (or into shards of one sample).

``split_by_qname`` deals the reads of a bowtie file, each read's lines
(consecutive, one read name) kept together, round-robin into n files: the
split of ``bench.py::ensure_multisample_fixture`` that makes BASELINE.json
config 5's 16 samples from the SE bench sample, each ~1/n of its reads.
``chip_smoke.py`` (phase 13) uses it for ``-M``, ``--batch_samples`` and
``--dist_merge_shards``.
"""

from __future__ import annotations

import os
from typing import List


def split_by_qname(aln: str, out_dir: str, stem: str, n: int) -> List[str]:
    """Write the reads of ``aln`` into ``out_dir/{stem}{i:02d}.bowtieout``
    for i < n (read k to file k mod n) and a list file
    ``out_dir/{stem}.list`` naming them; returns the n paths."""
    os.makedirs(out_dir, exist_ok=True)
    paths = [os.path.join(out_dir, f"{stem}{i:02d}.bowtieout")
             for i in range(n)]
    outs = [open(p, "w", buffering=1 << 20) for p in paths]
    try:
        last_id, cur = None, -1
        with open(aln) as fh:
            for ln in fh:
                rid = ln[:ln.index("\t")]
                if rid != last_id:
                    last_id = rid
                    cur = (cur + 1) % n
                outs[cur].write(ln)
    finally:
        for o in outs:
            o.close()
    with open(os.path.join(out_dir, f"{stem}.list"), "w") as fh:
        fh.write("\n".join(paths) + "\n")
    return paths
