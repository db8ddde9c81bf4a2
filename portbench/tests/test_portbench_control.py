"""The likelihood cells' control: the reference in bfloat16 put in the
program's place fails the limit that sound runs of the program pass.
On the card at the cells' own size over three seeds (``cuda``), and on
the CPU at a small size."""
import json
from pathlib import Path

import pytest
import torch

import control

CELLS = ["wgs30x-pe150.hc-batched", "tn-wgs-t75n30.m2-batched"]
SMALL = dict(read_len=40, hap_len_min=50, hap_len_max=70, pool_regions=12,
             max_pairs_per_call=64, caller_threads=2,
             sample_calls_per_thread=2,
             read_groups=[{"name": "sample", "depth": 3, "germline_af": 0.5,
                           "somatic_af": 0.3}])


def _limit(cell):
    traffic = cell.split(".")[1]
    path = Path(control.HERE) / "traffic" / f"{traffic}.json"
    return json.loads(path.read_text())["limit_logp_gap"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_cpu(cell):
    r = control.readings(cell, 2 ** 31 + 1, 1.5, True,
                         devices=[torch.device("cpu")], overrides=SMALL)
    assert r["logp_gap_max"] <= _limit(cell) < r["logp_gap_max.control"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for seed in (1, 2, 3):
        r = control.readings(cell, seed, 3.0, True)
        assert r["logp_gap_max"] <= _limit(cell) < r["logp_gap_max.control"]
