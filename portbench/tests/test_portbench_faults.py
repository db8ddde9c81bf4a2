"""A whole run of each cell on the CPU, at a small size: sound, it is
correct; with the timed path broken underneath (an answer altered where
the program produces it, or a call that fails in either window),
``correct`` comes out false.  The look for a card is skipped
(``devices`` given); everything after it runs."""
import json

import pytest
import torch

import harness
import run

SMALL = dict(read_len=40, hap_len_min=50, hap_len_max=70, pool_regions=8,
             max_pairs_per_call=64, caller_threads=2,
             sample_calls_per_thread=2, trace_seconds=0.5)
GROUPS = {
    "wgs30x-pe150.hc-batched": [
        {"name": "sample", "depth": 3, "germline_af": 0.5,
         "somatic_af": 0.0}],
    "tn-wgs-t75n30.m2-batched": [
        {"name": "tumor", "depth": 3, "germline_af": 0.5, "somatic_af": 0.3},
        {"name": "normal", "depth": 2, "germline_af": 0.5,
         "somatic_af": 0.0}],
}
CELLS = list(GROUPS)


def _run(capsys, cell, seconds, trace=0):
    rc = run.main(["--workload", cell, "--seed", str(2 ** 31 + 3),
                   "--seconds", str(seconds), "--trace", str(trace)],
                  devices=[torch.device("cpu")],
                  overrides=dict(SMALL, read_groups=GROUPS[cell]))
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()[-1]
    return json.loads(out)


def _spoil_likelihood(monkeypatch):
    from falcon_genome_tpu_torch.ops import pairhmm
    real = pairhmm.pairhmm_sc

    def altered(*a, **k):
        out = real(*a, **k).clone()
        out[len(out) // 2] += 0.01
        return out

    monkeypatch.setattr(pairhmm, "pairhmm_sc", altered)


@pytest.mark.parametrize("cell", CELLS)
def test_likelihood_cell(cell, capsys, monkeypatch):
    sound = _run(capsys, cell, 1.5)
    assert sound["correct"] and sound["attempted"] > 0
    assert sound["failed"] == 0
    assert list(sound)[-1] == "checks"
    _spoil_likelihood(monkeypatch)
    assert not _run(capsys, cell, 1.5)["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_failed_call_in_traced_window(cell, capsys, monkeypatch):
    """A call that raises in the traced window fails the run, though
    every call of the untraced window was sound."""
    real = harness.run_window

    def failing(svc, *a, pass_no=0, **k):
        if pass_no == 1:
            submit = svc.submit

            def boom(i):
                raise RuntimeError("the entry failed")

            svc.submit = boom
            try:
                return real(svc, *a, pass_no=pass_no, **k)
            finally:
                svc.submit = submit
        return real(svc, *a, pass_no=pass_no, **k)

    monkeypatch.setattr(harness, "run_window", failing)
    res = _run(capsys, cell, 1.0, trace=1)
    assert not res["correct"]
    assert res["failed"] == 2               # one a caller thread
    assert res["attempted"] >= res["failed"]
