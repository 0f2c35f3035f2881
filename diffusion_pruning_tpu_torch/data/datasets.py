"""Dataset loaders: COCO captions, CC3M TSV and CC3M webdataset layouts.

The JAX package's `data/datasets.py` (which imports no JAX), kept as a copy
so that the port imports nothing of it. COCO annotation JSON → one row per
caption with the split-dependent file naming; the CC3M training TSV
(caption\tlink) joined against downloaded image files whose name starts
with the TSV row index; CC3M webdataset tar shards of `<key>.jpg` +
`<key>.txt` pairs, as `shard.tar::member` image specs. Each returns column
dicts {'image': paths, 'caption': captions}.
"""
from __future__ import annotations

import json
import os
import pickle
from typing import Dict, List, Optional


def load_coco_dataset(images_dir: str, annotations_file: str) -> Dict[str, List[str]]:
    with open(annotations_file) as f:
        ann = json.load(f)
    images, captions = [], []
    split_name = os.path.basename(images_dir.rstrip("/"))
    for capt in ann["annotations"]:
        if "2014" in images_dir:
            path = os.path.join(images_dir, f"COCO_{split_name}_{capt['image_id']:012d}.jpg")
        else:
            path = os.path.join(images_dir, f"{capt['image_id']:012d}.jpg")
        images.append(path)
        captions.append(capt["caption"])
    return {"image": images, "caption": captions}


def load_cc3m_dataset(data_dir: str, split: str = "train",
                      split_file: str = "Train_GCC-training.tsv",
                      split_dir: str = "training",
                      names_cache: Optional[str] = None) -> Dict[str, List[str]]:
    captions: List[str] = []
    with open(os.path.join(data_dir, split_file)) as f:
        for line in f:
            captions.append(line.split("\t", 1)[0])
    cache = names_cache or os.path.join(data_dir, f"{split}_cc3m_names.pkl")
    if os.path.exists(cache):
        with open(cache, "rb") as fh:
            names = pickle.load(fh)
    else:
        names = os.listdir(os.path.join(data_dir, split_dir))
        try:
            with open(cache, "wb") as fh:
                pickle.dump(names, fh)
        except OSError:
            pass
    paths = [os.path.join(data_dir, split_dir, n) for n in names]
    idx = [int(os.path.basename(p).split("_")[0]) for p in paths]
    caps = [captions[i] for i in idx]
    return {"image": paths, "caption": caps}


def load_cc3m_webdataset(data_dir: str, split_dir: str = "training",
                         index_cache: Optional[str] = None) -> Dict[str, List[str]]:
    """CC3M in webdataset layout: tar shards of `<key>.jpg` + `<key>.txt`
    caption pairs. The reference's own webdataset path is broken (its
    `load_cc3m_webdataset` import in scripts/metrics/save_captions.py:3 does
    not exist); this is the working equivalent. Image "paths" are
    `shard.tar::member` specs the loader resolves lazily; captions are read
    once and cached beside the shards."""
    import tarfile

    shard_root = os.path.join(data_dir, split_dir)
    shards = sorted(f for f in os.listdir(shard_root) if f.endswith(".tar"))
    cache = index_cache or os.path.join(data_dir, f"{split_dir}_wds_index.pkl")
    if os.path.exists(cache):
        with open(cache, "rb") as fh:
            return pickle.load(fh)
    images: List[str] = []
    captions: List[str] = []
    for shard in shards:
        path = os.path.join(shard_root, shard)
        with tarfile.open(path) as tf:
            caps: Dict[str, str] = {}
            imgs: Dict[str, str] = {}
            for m in tf.getmembers():
                if not m.isfile():
                    continue
                key, ext = os.path.splitext(m.name)
                if ext in (".txt", ".caption"):
                    caps[key] = tf.extractfile(m).read().decode("utf-8").strip()
                elif ext in (".jpg", ".jpeg", ".png", ".webp"):
                    imgs[key] = m.name
            for key in sorted(imgs):
                if key in caps:
                    images.append(f"{path}::{imgs[key]}")
                    captions.append(caps[key])
    cols = {"image": images, "caption": captions}
    try:
        with open(cache, "wb") as fh:
            pickle.dump(cols, fh)
    except OSError:
        pass
    return cols


def shard_by_process(columns: Dict[str, List[str]], process_index: int,
                     process_count: int) -> Dict[str, List[str]]:
    """Split dataset rows across hosts (the reference's webdataset
    `nodesplitter`, pdm/utils/dist_utils.py:14-27): strided so shards stay
    balanced regardless of ordering."""
    return {k: v[process_index::process_count] for k, v in columns.items()}


def get_dataset(data_cfg) -> Dict[str, Dict[str, List[str]]]:
    """Dispatch on data_dir contents (data_utils.py:12-57): returns
    {'train': columns, 'validation': columns}."""
    data_dir = data_cfg.data_dir
    name = getattr(data_cfg, "dataset_name", "") or ""
    year = getattr(data_cfg, "year", 2014)
    if "coco" in name or "coco" in data_dir:
        train = load_coco_dataset(
            os.path.join(data_dir, "images", f"train{year}"),
            os.path.join(data_dir, "annotations", f"captions_train{year}.json"))
        val = load_coco_dataset(
            os.path.join(data_dir, "images", f"val{year}"),
            os.path.join(data_dir, "annotations", f"captions_val{year}.json"))
        return {"train": train, "validation": val}
    if "cc3m" in name or "conceptual_captions" in data_dir or "cc3m" in data_dir:
        def _is_wds(split_dir):
            p = os.path.join(data_dir, split_dir)
            return os.path.isdir(p) and any(f.endswith(".tar") for f in os.listdir(p))

        if _is_wds("training"):
            return {"train": load_cc3m_webdataset(data_dir, "training"),
                    "validation": load_cc3m_webdataset(data_dir, "validation")}
        train = load_cc3m_dataset(data_dir, "train", "Train_GCC-training.tsv", "training")
        val = load_cc3m_dataset(data_dir, "validation",
                                "Validation_GCC-1.1.0-Validation.tsv", "validation")
        return {"train": train, "validation": val}
    raise ValueError(f"cannot infer dataset from data_dir={data_dir!r} name={name!r}")
