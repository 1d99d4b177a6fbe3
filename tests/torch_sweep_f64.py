"""Which package's SSv2 sweep moved, when ``test_torch_curriculum_run.py``'s
embeddings disagree: each package's CSV against a float64 embedding of the
port's checkpoint of the same stage, over frames decoded natively and in
Python.

    python tests/torch_sweep_f64.py BASETEMP

where ``BASETEMP`` is the ``--basetemp`` of a pytest run of
``test_videomae_curriculum_matches_jax``.  The CSV that is near the float64
embedding of one decode path (to about 1e-6) took that path.
"""

import sys
from pathlib import Path

import numpy as np
import pandas as pd
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from bvc_tpu_torch.evalbench.datasets import SSv2Dataset  # noqa: E402
from bvc_tpu_torch.evalbench.extract import load_family_model  # noqa: E402
from bvc_tpu_torch.utils.config import TrainConfig  # noqa: E402
from torch_tiny_runs import tiny_cfg  # noqa: E402

RUN_IDS = ["dev_1_g0_default_1_0", "dev_2_g1_default_2_0"]


def main(root: Path) -> None:
    cfg = tiny_cfg(TrainConfig, "videomae", "", "", "").model
    runs = root / "videomae_runs0"
    for rid in RUN_IDS:
        model = load_family_model("videomae", str(runs / "port" / f"model_{rid}.pth.tar"),
                                  cfg).double().eval()
        for phase, sub in (("train", ""), ("test", "test")):
            ref = {}
            for use_native in (True, False):
                ds = SSv2Dataset(str(root / "ssv20"), 12, cfg.num_frames, phase == "train",
                                 cfg.image_size, use_native=use_native)
                clips = np.stack([ds[i][0] for i in range(len(ds))])
                with torch.no_grad():
                    ref[use_native] = model.embed(torch.from_numpy(clips).double()).numpy()
            for pkg in ("port", "jax"):
                csv = pd.read_csv(runs / pkg / "benchmarks" / "ssv2" / sub
                                  / f"embeddings_{rid}.csv").filter(like="dim").to_numpy()
                print(f"{rid} {phase} {pkg}: max|csv - f64(native)| "
                      f"{np.abs(csv - ref[True]).max():.3g}, max|csv - f64(python)| "
                      f"{np.abs(csv - ref[False]).max():.3g}, max|f64| "
                      f"{np.abs(ref[True]).max():.3g}")


if __name__ == "__main__":
    main(Path(sys.argv[1]))
