"""The input pipeline (counterpart of :mod:`bvc_tpu.data`): index math,
transforms, datasets, the packed corpus, the per-family factories and the
GPU loader."""

from bvc_tpu_torch.data.indexing import (  # noqa: F401
    AGE_GROUPS,
    get_fold,
    get_fpath2framelist,
    get_fpathlist,
    get_fpathseqlist,
    get_group,
    get_train_val_split,
)
