"""Offline evaluation of embedding CSVs → tidy score DataFrames
(counterpart of :mod:`bvc_tpu.evalbench.evaluators`).

Re-implements the notebook's evaluator classes and folder sweeps
(``notebooks/EvaluateEmbeddings.ipynb`` cells 6-11): SSv2 (label CSVs),
UCF101 (fnames ARE the labels), Toybox (labels parsed from
``category_id_pivothead_trans.mp4`` filenames, exemplar-held-out
option), CIFAR-10, plus ``parse_fname`` and
``proc_result_folder``.
"""

from __future__ import annotations

import os
from copy import deepcopy
from pathlib import Path

import numpy as np
import pandas as pd

from bvc_tpu_torch.evalbench.scores import get_nn_score, get_separability_score, train_test_split
from bvc_tpu_torch.utils.config import RunId


def parse_fname(fp: str) -> dict:
    """Run metadata parsed back out of an embeddings CSV name
    (notebook cell 9)."""
    stem = Path(fp).stem
    if stem.startswith("embeddings_"):
        stem = stem[len("embeddings_"):]
    rid = RunId.parse(stem)
    return {
        "Curriculum": rid.curriculum,
        "Stage": rid.stage,
        "Condition": rid.condition,
        "Seed": str(rid.seed),
        "Train Groups": rid.train_groups_seen(),
        "data_id": "_".join([rid.curriculum, str(rid.seed), rid.condition]),
    }


class SSv2Eval:
    """Labels from ``train_easy10.csv``/``val_easy10.csv`` keyed by
    ``<fname>.webm`` (cell 6)."""

    def __init__(self, label_paths: dict[str, str]):
        self.labels_df = {
            phase: pd.read_csv(p).set_index("fname")
            for phase, p in label_paths.items()
        }

    def add_labels_to_df(self, df: pd.DataFrame, phase: str) -> pd.DataFrame:
        df = df.copy()
        df["category"] = df["fnames"].apply(
            lambda fn: self.labels_df[phase].loc[str(fn) + ".webm", "label"]
        )
        return df

    def proc_train_test(self, data_fpaths: dict[str, str], score_type: str = "category",
                        eval_type: str = "linear", n_jobs: int = 8):
        dfs = {
            phase: self.add_labels_to_df(pd.read_csv(fp), phase)
            for phase, fp in data_fpaths.items()
        }
        if eval_type == "linear":
            _, test_score, _, _ = get_separability_score(
                dfs["train"], dfs["test"], "category", ret_preds=True, n_jobs=n_jobs
            )
            return test_score
        return get_nn_score(dfs["train"], dfs["test"], "category", metric="cosine")


class UCF101Eval:
    """fnames carry the class label directly (cell 7)."""

    def add_labels_to_df(self, df: pd.DataFrame) -> pd.DataFrame:
        df = df.copy()
        df["category"] = df["fnames"]
        return df

    def proc_train_test(self, data_fpaths, score_type: str = "category",
                        eval_type: str = "linear", n_jobs: int = 8):
        dfs = {p: self.add_labels_to_df(pd.read_csv(fp)) for p, fp in data_fpaths.items()}
        if eval_type == "linear":
            _, test_score, _, _ = get_separability_score(
                dfs["train"], dfs["test"], "category", ret_preds=True, n_jobs=n_jobs
            )
            return test_score
        return get_nn_score(dfs["train"], dfs["test"], "category", metric="cosine")


class ToyBoxEval:
    """Filename-encoded labels, exemplar-held-out split (cell 8):
    ``truck_30_pivothead_rzminus.mp4`` → category 'truck',
    identity 'truck30', transformation 'rzminus'."""

    # Known-bad fnames in the real Toybox embeddings CSV, patched by the
    # notebook's ``fix_fnames`` (cell 8) at these positional rows.  The
    # reference applies the iloc writes unconditionally; we only patch a
    # row when its fname is actually malformed (cannot yield all three
    # labels) so synthetic corpora aren't corrupted, and warn about any
    # malformed fname at an unexpected position.
    FNAME_FIXES = {
        2163: "giraffe_02_pivothead_rzplus.mp4",
        1851: "duck_06_pivothead_rxminus.mp4",
        751: "car_03_pivothead_rzminus.mp4",
    }

    def __init__(self, exemplar: bool = True):
        self.exemplar = exemplar

    @staticmethod
    def _well_formed(fname) -> bool:
        parts = str(fname).split(".")[0].split("_")
        return len(parts) >= 4

    def fix_fnames(self, df: pd.DataFrame) -> pd.DataFrame:
        """Port of the notebook's hard-coded filename corrections."""
        import warnings

        df = df.copy()
        col = df.columns.get_loc("fnames")
        for pos, good in self.FNAME_FIXES.items():
            if pos < len(df) and not self._well_formed(df.iloc[pos, col]):
                df.iloc[pos, col] = good
        bad = [f for f in df["fnames"] if not self._well_formed(f)]
        if bad:
            warnings.warn(
                f"{len(bad)} Toybox fnames remain malformed after fix_fnames "
                f"(first: {bad[0]!r}); label parsing will fail for them"
            )
        return df

    @staticmethod
    def get_categorylabel(fname: str) -> str:
        return fname.split(".")[0].split("_")[0]

    @staticmethod
    def get_identitylabel(fname: str) -> str:
        parts = fname.split(".")[0].split("_")
        return parts[0] + parts[1]

    @staticmethod
    def get_translabel(fname: str) -> str:
        return fname.split(".")[0].split("_")[3]

    def add_labels_to_df(self, df: pd.DataFrame, labels) -> pd.DataFrame:
        df = df.copy()
        if "category" in labels:
            df["category"] = df["fnames"].apply(self.get_categorylabel)
        if "identity" in labels:
            df["identity"] = df["fnames"].apply(self.get_identitylabel)
        if "transformation" in labels:
            df["transformation"] = df["fnames"].apply(self.get_translabel)
        return df

    def get_exemplar_split(self, df: pd.DataFrame, test_size: float = 0.33,
                           random_state=None):
        train_rows, test_rows = [], []
        for cat in df["category"].unique():
            cdata = df[df["category"] == cat]
            ids = np.asarray(cdata["identity"].unique())
            id_train, id_test = train_test_split(
                ids, test_size=test_size, random_state=random_state
            )
            train_rows.append(cdata[cdata["identity"].isin(id_train)])
            test_rows.append(cdata[cdata["identity"].isin(id_test)])
        return (
            pd.concat(train_rows, ignore_index=True),
            pd.concat(test_rows, ignore_index=True),
        )

    def get_separability_score(self, df: pd.DataFrame, label: str,
                               method: str = "sgd", n_jobs: int = 8):
        if self.exemplar and label == "category":
            train_df, test_df = self.get_exemplar_split(df)
            return get_separability_score(train_df, test_df, label,
                                          method=method, n_jobs=n_jobs)
        return get_separability_score(df, None, label, method=method, n_jobs=n_jobs)

    def proc_fp(self, fp: str, ds_task: str, n_jobs: int = 8) -> float:
        df = self.fix_fnames(pd.read_csv(fp))
        df = self.add_labels_to_df(df, ["category", "identity", "transformation"])
        _, test_score = self.get_separability_score(df, ds_task, n_jobs=n_jobs)
        return test_score

    def proc_train_test(self, data_fpaths, score_type: str = "category",
                        eval_type: str = "linear", n_jobs: int = 8):
        dfs = {
            p: self.add_labels_to_df(self.fix_fnames(pd.read_csv(fp)),
                                     ["category", "identity", "transformation"])
            for p, fp in data_fpaths.items()
        }
        if eval_type == "linear":
            _, test_score, _, _ = get_separability_score(
                dfs["train"], dfs["test"], score_type, ret_preds=True, n_jobs=n_jobs
            )
            return test_score
        return get_nn_score(dfs["train"], dfs["test"], score_type, metric="cosine")


class Cifar10Eval(UCF101Eval):
    """CIFAR fnames are the label strings — same path as UCF101."""


def make_evaluator(ds_task: str, **kw):
    if ds_task == "ssv2":
        return SSv2Eval(kw["label_paths"]), "category"
    if ds_task == "tb_cat":
        return ToyBoxEval(kw.get("exemplar", True)), "category"
    if ds_task == "tb_trans":
        return ToyBoxEval(kw.get("exemplar", True)), "transformation"
    if ds_task == "ucf101":
        return UCF101Eval(), "category"
    if ds_task == "cifar10":
        return Cifar10Eval(), "category"
    raise ValueError(f"unknown ds_task {ds_task!r}")


def proc_result_folder_tb(
    emb_root: str,
    ds_task: str,
    iter_per_stage: int,
    n_jobs: int = 8,
    exemplar: bool = False,
) -> pd.DataFrame:
    """Toybox single-CSV sweep (cell 10): every train CSV is scored by an
    internal exemplar/random split instead of a train/test CSV pair."""
    evaluator = ToyBoxEval(exemplar=exemplar)
    score_col = "category" if ds_task == "tb_cat" else "transformation"
    records = []
    for fname in sorted(os.listdir(emb_root)):
        fp = os.path.join(emb_root, fname)
        if Path(fp).suffix != ".csv":
            continue
        record = parse_fname(fp)
        record[score_col] = evaluator.proc_fp(fp, score_col, n_jobs=n_jobs)
        record["Iteration"] = iter_per_stage * record["Stage"]
        records.append(deepcopy(record))
    return pd.DataFrame.from_records(records)


def proc_result_folder(
    emb_root: str,
    ds_task: str,
    iter_per_stage: int,
    eval_type: str = "linear",
    n_jobs: int = 8,
    **evaluator_kw,
) -> pd.DataFrame:
    """Sweep ``emb_root`` pairing each train CSV with ``test/<same name>``
    into a tidy DataFrame (cell 11)."""
    evaluator, score_col = make_evaluator(ds_task, **evaluator_kw)
    records = []
    for fname in sorted(os.listdir(emb_root)):
        train_fp = os.path.join(emb_root, fname)
        if Path(train_fp).suffix != ".csv":
            continue
        test_fp = os.path.join(emb_root, "test", fname)
        if not os.path.exists(test_fp):
            continue
        record = parse_fname(train_fp)
        result = evaluator.proc_train_test(
            {"train": train_fp, "test": test_fp}, score_col,
            eval_type=eval_type, n_jobs=n_jobs,
        )
        if eval_type == "linear":
            record[score_col] = result
        else:
            record["Top1"] = result[1]
            record["Top5"] = result[5]
            record["Top10"] = result[10]
        record["Iteration"] = iter_per_stage * record["Stage"]
        records.append(deepcopy(record))
    return pd.DataFrame.from_records(records)
