"""Faults of the rotary positions, planted under the timed path of a cell
whose model rotates its queries and keys (``vjepa2_g.train.b16``), to see
``correct`` come out false (``portbench/tests/test_portbench_vjepa2.py``
and the limits' readings; the benchmark's own runs plant none):

- ``rope_off``: every block's rotation left out (q and k as the qkv
  product gives them);
- ``shifted_positions``: the context encoder's tokens rotated at positions
  ``0 .. Ke - 1`` in place of their kept ids.

They reach the program's names for the length of a step and put them back.

    python3 -m portbench.faults_rope run --workload <cell> --seed <n> --seconds <s> \\
        --fault rope_off
    python3 -m portbench.faults_rope readings --workload <cell> --control-seeds ... \\
        --faults half_batch,rope_off,shifted_positions

run ``portbench.run`` or ``portbench.controls.readings`` with these faults
registered beside ``portbench/faults.py``'s.
"""

from __future__ import annotations

import sys

import torch

from portbench.faults import FAULTS, Fault


class RopeOff(Fault):
    def call(self, step, state, batch, *args, **kw):
        from bvc_tpu_torch.models import vit

        rotate = vit.rope3d
        vit.rope3d = lambda q, k, pos, grid: (q, k)
        try:
            return step(state, batch, *args, **kw)
        finally:
            vit.rope3d = rotate


class ShiftedPositions(Fault):
    def call(self, step, state, batch, *args, **kw):
        from bvc_tpu_torch.models.jepa import JEPAEncoder

        ids = JEPAEncoder.token_ids

        def shifted(encoder, keep_idx, batch_rows, n):
            if keep_idx is None:
                return ids(encoder, keep_idx, batch_rows, n)
            return torch.arange(keep_idx.shape[1], device=keep_idx.device).expand(batch_rows, -1)

        JEPAEncoder.token_ids = shifted
        try:
            return step(state, batch, *args, **kw)
        finally:
            JEPAEncoder.token_ids = ids


ROPE_FAULTS = {"rope_off": RopeOff, "shifted_positions": ShiftedPositions}


def register() -> None:
    FAULTS.update(ROPE_FAULTS)


def main(argv: list[str]) -> int:
    register()
    if argv[:1] == ["run"]:
        from portbench import run

        return run.main(argv[1:])
    if argv[:1] == ["readings"]:
        from portbench.controls import readings

        sys.argv = [sys.argv[0], *argv[1:]]
        readings.main()
        return 0
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
