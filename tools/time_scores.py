"""Time the evaluation's scoring at the benchmarks' sizes, on the CPU: the
port's (``bvc_tpu_torch.evalbench``) against the JAX package's, which scores
with scikit-learn.

Synthetic ViT-B embeddings (768 columns, float64: class centres of scale
0.1 plus unit noise, where the probe reads about 0.7 test accuracy on
SSv2-easy10's size) with each benchmark's classes and row counts:

- ``ssv2``: SSv2-easy10, 10 classes; 9,710 train and 1,424 val rows (SSv2's
  168,913 train and 24,777 val videos over 174 classes, times 10/174).
- ``ucf101``: UCF101 split 1, 101 classes; 9,537 train and 3,783 test rows.

For each, in turn for the port and the reference under the same
``np.random.seed``: ``get_separability_score`` (the linear probe) on the
frames in memory, then ``proc_result_folder`` with ``eval_type`` linear and
nn over one run id's train/test CSVs written to disk.  The two packages'
results must be equal; the script fails otherwise.

    python -m tools.time_scores [--tasks ssv2,ucf101] [--n_jobs 8] [--out DIR]

Prints one JSON line per reading.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import pandas as pd

from bvc_tpu.evalbench import evaluators as ref_ev
from bvc_tpu.evalbench import scores as ref_scores
from bvc_tpu_torch.evalbench import evaluators as port_ev
from bvc_tpu_torch.evalbench import scores as port_scores

TASKS = {"ssv2": (10, 9710, 1424), "ucf101": (101, 9537, 3783)}
WIDTH = 768
RUN_ID = "dev_3_g2_default_2_0"


def frames(task: str, seed: int = 0) -> tuple[pd.DataFrame, pd.DataFrame]:
    classes, n_train, n_test = TASKS[task]
    rng = np.random.default_rng(seed)
    centres = 0.1 * rng.standard_normal((classes, WIDTH))
    out = []
    for n in (n_train, n_test):
        y = np.arange(n) % classes
        x = centres[y] + rng.standard_normal((n, WIDTH))
        df = pd.DataFrame(x, columns=[f"dim{i}" for i in range(WIDTH)])
        df.insert(0, "fnames", [f"class{c:03d}" for c in y])
        out.append(df)
    return out[0], out[1]


def write_folder(root: str, task: str, train: pd.DataFrame, test: pd.DataFrame) -> dict:
    """One run id's CSVs; for SSv2 the fnames become clip ids and the labels
    go to ``train_easy10.csv``/``val_easy10.csv``."""
    emb = os.path.join(root, "emb")
    os.makedirs(os.path.join(emb, "test"))
    kw = {}
    if task == "ssv2":
        kw["label_paths"] = {}
        for phase, df, base, name in (("train", train, 0, "train_easy10.csv"),
                                      ("test", test, 10 ** 6, "val_easy10.csv")):
            ids = np.arange(base, base + len(df))
            pd.DataFrame({"fname": [f"{i}.webm" for i in ids],
                          "label": df["fnames"]}).to_csv(os.path.join(root, name), index=False)
            df = df.assign(fnames=ids)
            kw["label_paths"][phase] = os.path.join(root, name)
            if phase == "train":
                train = df
            else:
                test = df
    train.to_csv(os.path.join(emb, f"embeddings_{RUN_ID}.csv"), index=False)
    test.to_csv(os.path.join(emb, "test", f"embeddings_{RUN_ID}.csv"), index=False)
    return {"emb_root": emb, **kw}


def timed(fn, seed: int = 0):
    np.random.seed(seed)
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tasks", default="ssv2,ucf101")
    p.add_argument("--n_jobs", type=int, default=8)
    p.add_argument("--out", default=None, help="directory for the CSVs (default: a temp dir)")
    args = p.parse_args(argv)
    for task in args.tasks.split(","):
        classes, n_train, n_test = TASKS[task]
        train, test = frames(task)
        head = {"task": task, "classes": classes, "train": n_train, "test": n_test,
                "width": WIDTH, "n_jobs": args.n_jobs}
        x_train = train.rename(columns={"fnames": "category"})
        x_test = test.rename(columns={"fnames": "category"})
        got = {}
        for name, module in (("port", port_scores), ("reference", ref_scores)):
            got[name], sec = timed(lambda: module.get_separability_score(
                x_train, x_test, "category", n_jobs=args.n_jobs))
            print(json.dumps({**head, "call": "get_separability_score", "package": name,
                              "seconds": sec,
                              "train_acc": got[name][0], "test_acc": got[name][1]}),
                  flush=True)
        if got["port"] != got["reference"]:
            raise SystemExit(f"{task}: the port's scores {got['port']} differ from the "
                             f"reference's {got['reference']}")
        with tempfile.TemporaryDirectory(dir=args.out) as root:
            kw = write_folder(root, task, train, test)
            emb = kw.pop("emb_root")
            for eval_type in ("linear", "nn"):
                dfs = {}
                for name, module in (("port", port_ev), ("reference", ref_ev)):
                    dfs[name], sec = timed(lambda: module.proc_result_folder(
                        emb, task, 100, eval_type=eval_type, n_jobs=args.n_jobs, **kw))
                    print(json.dumps({**head, "call": "proc_result_folder",
                                      "eval_type": eval_type, "package": name,
                                      "seconds": sec,
                                      "result": dfs[name].drop(columns="Train Groups")
                                      .iloc[0].to_dict()}, default=str), flush=True)
                pd.testing.assert_frame_equal(dfs["port"], dfs["reference"])


if __name__ == "__main__":
    main()
