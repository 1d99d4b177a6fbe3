"""``python -m bvc_tpu_torch.cli.dryrun_multichip`` (the counterpart of
``__graft_entry__._dryrun_multichip_impl``) over four gloo ranks on the
CPU: one tiny VideoMAE step under each layout of the port, every loss
finite; the layouts it picks for other rank counts."""

import math

import pytest

from bvc_tpu_torch.cli import dryrun_multichip


def test_every_layout_takes_a_finite_step_over_four_ranks(capsys):
    lines = dryrun_multichip.main(["--n", "4", "--device", "cpu", "--timeout", "240"])
    assert [line.split(" mode=")[1].split(" ")[0] for line in lines] == \
        ["tp", "fsdp", "zero1", "seq", "pipe"]
    assert "mesh={'data': 2, 'model': 2} mode=zero1 grad_accum=2" in lines[2]
    assert "mesh={'data': 1, 'seq': 4}" in lines[3] and "mesh={'data': 2, 'pipe': 2}" in lines[4]
    for line in lines:
        assert math.isfinite(float(line.rsplit("loss=", 1)[1])), line
    assert capsys.readouterr().out.splitlines() == lines


@pytest.mark.parametrize("n,want", [
    (1, [{"data": 1, "model": 1}] * 3 + [{"data": 1, "seq": 1}, {"data": 1, "pipe": 1}]),
    (2, [{"data": 1, "model": 2}] * 3 + [{"data": 1, "seq": 2}, {"data": 1, "pipe": 2}]),
    (8, [{"data": 4, "model": 2}] * 3 + [{"data": 2, "seq": 4}, {"data": 4, "pipe": 2}]),
])
def test_layouts_cover_the_ranks(n, want):
    got = dryrun_multichip.layouts(n)
    assert [shape for shape, *_ in got] == want
    assert [mode for _, mode, *_ in got] == ["tp", "fsdp", "zero1", "seq", "pipe"]


def test_cuda_without_enough_cards_raises(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="--n 2 needs 2 GPUs"):
        dryrun_multichip.main(["--n", "2"])
