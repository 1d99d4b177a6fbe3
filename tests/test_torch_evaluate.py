"""The port's evaluation step against ``bvc_tpu``'s: the scores (kNN
retrieval, the linear probe), the evaluators' folder sweeps for every
benchmark (SSv2 with its label CSVs, UCF101, CIFAR-10, Toybox by category
and by transformation, with train/test pairs and in single-CSV mode) and the
``evaluate_embeddings`` CLI, on one set of synthetic embedding CSVs.

The JAX package scores with scikit-learn, the port with its own copies of
the same algorithms (numpy, and the SGD fit in ``native/sgd.cpp``).
Tolerance: none.  Under the same
``np.random.seed`` (the probes draw their shuffle seeds from numpy's global
generator, as the reference's do) the DataFrames are equal
(``pd.testing.assert_frame_equal``), and so are the probes' fitted
parameters, bit for bit.
"""

import numpy as np
import pandas as pd
import pytest
from sklearn.linear_model import SGDClassifier as SkSGDClassifier
from sklearn.pipeline import make_pipeline
from sklearn.preprocessing import StandardScaler as SkStandardScaler

from bvc_tpu.cli import evaluate_embeddings as jax_cli
from bvc_tpu.evalbench import evaluators as jax_ev
from bvc_tpu.evalbench import scores as jax_scores
from bvc_tpu.utils.config import RunId as JaxRunId
from bvc_tpu_torch.cli import evaluate_embeddings as cli
from bvc_tpu_torch.evalbench import evaluators as ev
from bvc_tpu_torch.evalbench import scores
from bvc_tpu_torch.utils.config import RunId

RUN_IDS = ["dev_0_na_default_0_3", "dev_1_g0_default_1_3", "dev_2_g1_default_2_3",
           "adev_3_g0_MatchedSpatioTemporal_0_3", "untrained"]
TOYBOX = [f"{c}_{i:02d}_pivothead_{t}.mp4" for c in ("car", "duck", "truck")
          for i in range(6) for t in ("rxplus", "rzminus")]


def _embeddings(rng, labels, centers, width, spread):
    keys = sorted(set(labels))
    x = np.stack([centers[keys.index(label)] + spread * rng.standard_normal(width)
                  for label in labels])
    return pd.DataFrame(x, columns=[f"dim{i}" for i in range(width)])


def _write_folder(root, ds_task, spread=1.0, width=12, single=False):
    """One train CSV (and ``test/`` twin unless ``single``) per run id, the
    class clusters shared between the splits; SSv2 label CSVs beside."""
    rng = np.random.default_rng(len(ds_task) + 7 * single)
    if ds_task == "ssv2":
        fnames = {"train": list(range(24)), "test": list(range(100, 118))}
        labels = {ph: [f"verb{f % 3}" for f in names] for ph, names in fnames.items()}
        for ph, name in (("train", "train_labels.csv"), ("test", "val_labels.csv")):
            pd.DataFrame({"fname": [f"{f}.webm" for f in fnames[ph]],
                          "label": labels[ph]}).to_csv(root / name, index=False)
    elif ds_task.startswith("tb"):
        fnames = {"train": TOYBOX, "test": TOYBOX[::2]}
        pos = 3 if ds_task == "tb_trans" else 0
        labels = {ph: [f.split(".")[0].split("_")[pos] for f in names]
                  for ph, names in fnames.items()}
    else:
        classes = ["Jump", "Run", "Swim", "Bike"] if ds_task == "ucf101" else ["cat", "dog",
                                                                                "ship"]
        fnames = {"train": classes * 6, "test": classes * 4}
        labels = fnames
    emb = root / "emb"
    (emb / "test").mkdir(parents=True)
    for rid in RUN_IDS:
        centers = rng.standard_normal((4, width)) * 2
        for ph, sub in (("train", ""), ("test", "test")):
            if single and ph == "test":
                continue
            df = _embeddings(rng, labels[ph], centers, width, spread)
            df.insert(0, "fnames", fnames[ph])
            df.to_csv(emb / sub / f"embeddings_{rid}.csv", index=False, float_format="%.6f")
    (emb / "notes.txt").write_text("not a CSV")
    return emb


def _both(call, seed=0):
    """``call(package)`` for the port and for JAX, each after
    ``np.random.seed(seed)``."""
    out = []
    for package in (ev, jax_ev):
        np.random.seed(seed)
        out.append(call(package))
    return out


def _labels(root):
    return {"train": str(root / "train_labels.csv"), "test": str(root / "val_labels.csv")}


@pytest.mark.parametrize("eval_type", ["linear", "nn"])
@pytest.mark.parametrize("ds_task", ["ssv2", "ucf101", "cifar10", "tb_cat", "tb_trans"])
def test_proc_result_folder_matches_jax(ds_task, eval_type, tmp_path):
    emb = _write_folder(tmp_path, ds_task, spread=3.0)
    kw = {"label_paths": _labels(tmp_path)} if ds_task == "ssv2" else {}
    ours, theirs = _both(lambda p: p.proc_result_folder(str(emb), ds_task, 100,
                                                        eval_type=eval_type, n_jobs=1, **kw))
    pd.testing.assert_frame_equal(ours, theirs)
    assert len(ours) == len(RUN_IDS)
    assert list(ours["Iteration"]) == [100 * s for s in ours["Stage"]]


@pytest.mark.parametrize("exemplar", [False, True], ids=["random", "exemplar"])
@pytest.mark.parametrize("ds_task", ["tb_cat", "tb_trans"])
def test_proc_result_folder_tb_matches_jax(ds_task, exemplar, tmp_path):
    """Toybox single-CSV mode: each CSV split inside the probe, by exemplar
    (``get_exemplar_split``, numpy's global generator) or by
    ``train_test_split(random_state=42)``."""
    emb = _write_folder(tmp_path, ds_task, spread=2.0, single=True)
    for seed in (0, 1):
        ours, theirs = _both(lambda p: p.proc_result_folder_tb(str(emb), ds_task, 50,
                                                               n_jobs=1, exemplar=exemplar),
                             seed)
        pd.testing.assert_frame_equal(ours, theirs)


@pytest.mark.parametrize("argv", [
    ["-ds_task", "ssv2", "--eval_type", "linear"],
    ["-ds_task", "ssv2", "--eval_type", "nn", "--iter_per_stage", "7"],
    ["-ds_task", "tb_cat", "--tb_single_csv", "--exemplar"],
], ids=["ssv2-linear", "ssv2-nn", "tb-single"])
def test_cli_matches_jax(argv, tmp_path, capsys):
    """Same flags, the same printed table and the same CSV written."""
    emb = _write_folder(tmp_path, "tb_cat" if "tb_cat" in argv else "ssv2", spread=2.0,
                        single="--tb_single_csv" in argv)
    labels = ["--ssv2_train_labels", str(tmp_path / "train_labels.csv"),
              "--ssv2_test_labels", str(tmp_path / "val_labels.csv")]
    outs = []
    for module, name in ((cli, "ours.csv"), (jax_cli, "theirs.csv")):
        np.random.seed(3)
        df = module.main(["-emb_root", str(emb), "--n_jobs", "1", "-o", str(tmp_path / name)]
                         + argv + labels)
        outs.append((df, capsys.readouterr().out.replace(name, "")))
    pd.testing.assert_frame_equal(outs[0][0], outs[1][0])
    assert outs[0][1] == outs[1][1]
    assert (tmp_path / "ours.csv").read_text() == (tmp_path / "theirs.csv").read_text()
    flags = [{a.dest: (a.default, a.type) for a in m.build_parser()._actions}
             for m in (cli, jax_cli)]
    assert flags[0] == flags[1]
    with pytest.raises(SystemExit, match="ssv2 needs"):
        cli.main(["-emb_root", str(emb), "-ds_task", "ssv2"])


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
@pytest.mark.parametrize("classes", [2, 3, 7])
def test_scores_match_jax(classes, metric, tmp_path):
    """Both scores on embeddings of 2, 3 and 7 classes (the probe's binary
    and one-vs-rest paths), with and without a test frame, tight and
    overlapping clusters; the nn score's JSON file."""
    for trial, spread in enumerate((0.2, 2.5, 6.0)):
        rng = np.random.default_rng(10 * classes + trial)
        labels = [f"c{i % classes}" for i in range(5 * classes + trial)]
        centers = rng.standard_normal((classes, 24)) * 2
        train = _embeddings(rng, labels, centers, 24, spread).assign(cat=labels)
        test = _embeddings(rng, labels[::-1], centers, 24, spread).assign(cat=labels[::-1])
        for df_test in (test, None):
            for seed in (0, 5):
                got = []
                for package in (scores, jax_scores):
                    np.random.seed(seed)
                    got.append(package.get_separability_score(train, df_test, "cat",
                                                              ret_preds=True, n_jobs=1))
                assert got[0][:2] == got[1][:2]
                np.testing.assert_array_equal(got[0][2], got[1][2])
                np.testing.assert_array_equal(got[0][3], got[1][3])
        assert scores.get_nn_score(train, test, "cat", metric) == jax_scores.get_nn_score(
            train, test, "cat", metric)
    for package, sub in ((scores, "ours"), (jax_scores, "theirs")):
        (tmp_path / sub).mkdir()
        package.get_nn_score(train, test, "cat", metric, savedir=str(tmp_path / sub), run_id="r")
    assert ((tmp_path / "ours" / "r_topk_correct.json").read_text()
            == (tmp_path / "theirs" / "r_topk_correct.json").read_text())


@pytest.mark.parametrize("width", [8, 768])
def test_probe_parameters_match_sklearn(width):
    """The scaler's mean and scale, and the classifier's weights, intercepts
    and epochs, equal scikit-learn's bit for bit (768: the ViT width)."""
    rng = np.random.default_rng(width)
    for classes in (2, 4):
        labels = np.arange(40) % classes
        x = rng.standard_normal((classes, width))[labels] + rng.standard_normal((40, width))
        frame = pd.DataFrame(x, columns=[f"dim{i}" for i in range(width)])
        np.random.seed(11)
        ref = make_pipeline(SkStandardScaler(),
                            SkSGDClassifier(max_iter=5000, tol=1e-4, n_jobs=1)).fit(frame, labels)
        np.random.seed(11)
        ours = scores.LinearProbe().fit(np.asarray(frame, dtype=np.float64), labels)
        np.testing.assert_array_equal(ours.scaler.mean_, ref[0].mean_)
        np.testing.assert_array_equal(ours.scaler.scale_, ref[0].scale_)
        np.testing.assert_array_equal(ours.clf.coef_, ref[1].coef_)
        np.testing.assert_array_equal(ours.clf.intercept_, ref[1].intercept_)
        assert ours.clf.n_iter_ == ref[1].n_iter_


@pytest.mark.parametrize("classes", [2, 5])
def test_probe_threads_do_not_change_the_fit(classes):
    """``n_jobs`` threads share out the one-vs-rest fits and change nothing:
    1, 3 and every core (-1) give the same parameters, equal to
    scikit-learn's at ``n_jobs=4``."""
    rng = np.random.default_rng(classes)
    labels = np.arange(60) % classes
    x = rng.standard_normal((classes, 16))[labels] + rng.standard_normal((60, 16))
    np.random.seed(4)
    ref = SkSGDClassifier(max_iter=5000, tol=1e-4, n_jobs=4).fit(x, labels)
    for n_jobs in (1, 3, -1):
        np.random.seed(4)
        ours = scores.SGDClassifier(n_jobs).fit(x, labels)
        np.testing.assert_array_equal(ours.coef_, ref.coef_)
        np.testing.assert_array_equal(ours.intercept_, ref.intercept_)
        assert ours.n_iter_ == ref.n_iter_


def test_unseen_label_and_svm_raise():
    train = pd.DataFrame({"dim0": [0.0, 1.0], "cat": ["a", "b"]})
    test = pd.DataFrame({"dim0": [0.5], "cat": ["z"]})
    with pytest.raises(ValueError, match="previously unseen labels"):
        scores.get_nn_score(train, test, "cat")
    with pytest.raises(ValueError, match="'sgd' probe only"):
        scores.get_separability_score(train, train, "cat", method="svm")


@pytest.mark.parametrize("fp", ["/x/embeddings_adev_1_g2_default_0_246.csv",
                                "embeddings_dev_3_g2_Matched_Spatial_2_101.csv",
                                "/x/embeddings_na.csv", "rnd_2_gr_shuffle_1_0.csv"])
def test_parse_fname_and_run_id_match_jax(fp):
    assert ev.parse_fname(fp) == jax_ev.parse_fname(fp)
    rid = RunId.parse(fp.rsplit("/", 1)[-1].removeprefix("embeddings_").removesuffix(".csv"))
    jrid = JaxRunId.parse(fp.rsplit("/", 1)[-1].removeprefix("embeddings_").removesuffix(".csv"))
    assert (str(rid), rid.train_groups_seen()) == (str(jrid), jrid.train_groups_seen())
    for ckpt in (f"/o/model_{rid}.pth.tar", f"model_{rid}.ckpt"):
        assert str(RunId.from_checkpoint_path(ckpt)) == str(JaxRunId.from_checkpoint_path(ckpt))
