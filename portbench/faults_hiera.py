"""Faults of Hiera's layout, planted under the timed path of the Hiera cell
(``hiera_h.train.b48``), to see ``correct`` come out false
(``portbench/tests/test_portbench_hiera.py`` and the limits' readings; the
benchmark's own runs plant none):

- ``global_mu``: every mask-unit attention made global over the clip's
  kept tokens (the same pooled queries, every key of the clip);
- ``qpool_mean``: the query and residual pools take the mean in place of
  the max;
- ``no_fusion``: the fusion heads left out (their outputs times 0, so that
  they still get a gradient, of zero), the encoder's output the last
  stage's alone.

They reach the program's names for the length of a step and put them back.

    python3 -m portbench.faults_hiera run --workload <cell> --seed <n> --seconds <s> \\
        --fault global_mu
    python3 -m portbench.faults_hiera readings --workload <cell> --control-seeds ... \\
        --faults half_batch,global_mu,qpool_mean,no_fusion

run ``portbench.run`` or ``portbench.controls.readings`` with these faults
registered beside ``portbench/faults.py``'s.
"""

from __future__ import annotations

import sys

from portbench.faults import FAULTS, Fault


class _Swap(Fault):
    """Replace ``name`` of the program's ``bvc_tpu_torch.models.hiera`` by
    :meth:`replacement` of the original for one step."""

    name = ""

    def replacement(self, original):
        raise NotImplementedError

    def call(self, step, state, batch, *args, **kw):
        from bvc_tpu_torch.models import hiera

        original = getattr(hiera, self.name)
        setattr(hiera, self.name, self.replacement(original))
        try:
            return step(state, batch, *args, **kw)
        finally:
            setattr(hiera, self.name, original)


class GlobalMU(_Swap):
    name = "mask_unit_attention"

    def replacement(self, original):
        from bvc_tpu_torch.models import hiera

        def global_mu(qkv, heads, windows, q_stride, attn_impl="auto"):
            return hiera.global_attention(qkv, heads, q_stride, attn_impl)

        return global_mu


class QPoolMean(_Swap):
    name = "pool"

    def replacement(self, original):
        return lambda x, stride: x.unflatten(1, (stride, -1)).mean(dim=1)


class NoFusion(_Swap):
    name = "fuse"

    def replacement(self, original):
        return lambda x, head: original(x, head) * 0


HIERA_FAULTS = {"global_mu": GlobalMU, "qpool_mean": QPoolMean, "no_fusion": NoFusion}


def register() -> None:
    FAULTS.update(HIERA_FAULTS)


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
