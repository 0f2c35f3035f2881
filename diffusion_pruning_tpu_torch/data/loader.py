"""Host-side input pipeline: decode → augment → tokenize → fixed-shape batches.

The JAX package's `data/loader.py`, batch for batch: the same files, seed
and settings give the same numpy batches in the same order.

* static batch shapes always: corrupt or missing images are *replaced* by
  resampling from the next 64 indices of the epoch, not dropped;
* images: resize shorter side → (random | center) crop → optional hflip →
  [-1, 1] float32 NHWC;
* draws: the epoch's order from `RandomState(seed + epoch)`, the crops and
  flips from `RandomState(seed * 7919 + epoch)`;
* JPEGs go through the top-level `dpt_native` extension (built from
  `native/decoder.cpp`) when it imports, else through Pillow;
* text: any tokenizer callable for CLIP ids and MPNet ids and mask
  (`tokenizers.py`).

Batches stay numpy dicts; the training loops move the keys their steps read
to the device (`training/loop.BATCH_KEYS`).

A data-parallel rank (`rows=`, its slice of each global batch) gets its rows
of the batches the one-process pipeline makes from the same seed. Where the
loader allows it, it decodes only those: with Pillow alone, the other rows'
crop and flip draws are made from their files' headers (the crop's bounds
need the image's size; no pixels are decoded), and a file that does not open
is replaced from the pool as when decoded. A file whose header reads but
whose pixels do not (a truncated JPEG) in another rank's rows is taken as
readable there, so from that row on this rank's rows can differ from the
one-process batch (they are still rows of the split, drawn as the loader
draws). With `dpt_native` the whole global batch is decoded and the rank
keeps its rows: the native decoder's fallback to Pillow depends on which
files it reads, which only decoding tells. Captions are tokenized for the
rank's rows alone.

`filter_dataset` assigns captions to experts batch by batch: captions →
MPNet embeddings → hypernet → cosine codebook index.
"""
from __future__ import annotations

import collections
import io
import queue as queue_mod
import tarfile
import threading
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

_TAR_CACHE: Dict[str, tarfile.TarFile] = {}
_TAR_LOCK = threading.Lock()
BACKUP_POOL = 64  # indices after a batch that can replace its unreadable images


def native_decoder():
    """The top-level `dpt_native` module (native/decoder.cpp's multithreaded
    libjpeg pipeline) when it imports, else None."""
    try:
        import dpt_native
    except ImportError:
        return None
    return dpt_native


def read_image_bytes(path: str) -> bytes:
    """Raw bytes of a plain path or of a `shard.tar::member` webdataset spec
    (`datasets.load_cc3m_webdataset`). Tar handles are cached per shard."""
    if "::" not in path:
        with open(path, "rb") as f:
            return f.read()
    shard, member = path.split("::", 1)
    with _TAR_LOCK:
        tf = _TAR_CACHE.get(shard)
        if tf is None:
            tf = _TAR_CACHE[shard] = tarfile.open(shard)
        return tf.extractfile(member).read()


def _resized(size, resolution: int):
    """The (w, h) the shorter side is resized to `resolution` at."""
    w, h = size
    scale = resolution / min(w, h)
    return max(resolution, round(w * scale)), max(resolution, round(h * scale))


def _crop_origin(size, resolution: int, train: bool, center_crop: bool,
                 rng: np.random.RandomState):
    w, h = size
    if train and not center_crop:
        return rng.randint(0, w - resolution + 1), rng.randint(0, h - resolution + 1)
    return (w - resolution) // 2, (h - resolution) // 2


def load_and_transform_image(path: str, resolution: int, train: bool,
                             center_crop: bool, random_flip: bool,
                             rng: np.random.RandomState) -> Optional[np.ndarray]:
    """Pillow decode + SD preprocessing; None for an unreadable file."""
    from PIL import Image
    try:
        img = Image.open(io.BytesIO(read_image_bytes(path))).convert("RGB")
    except Exception:  # any undecodable or missing file is resampled
        return None
    img = img.resize(_resized(img.size, resolution), Image.BILINEAR)
    x0, y0 = _crop_origin(img.size, resolution, train, center_crop, rng)
    img = img.crop((x0, y0, x0 + resolution, y0 + resolution))
    arr = np.asarray(img, dtype=np.float32) / 127.5 - 1.0  # [-1, 1] NHWC
    if train and random_flip and rng.rand() < 0.5:
        arr = arr[:, ::-1, :]
    return arr


def skip_image(path: str, resolution: int, train: bool, center_crop: bool, random_flip: bool,
               rng: np.random.RandomState) -> bool:
    """`load_and_transform_image`'s draws for a row another rank decodes,
    from the file's header alone (no pixels); False when it does not open."""
    from PIL import Image
    try:
        size = Image.open(io.BytesIO(read_image_bytes(path))).size
    except Exception:
        return False
    _crop_origin(_resized(size, resolution), resolution, train, center_crop, rng)
    if train and random_flip:
        rng.rand()
    return True


class DataPipeline:
    """Iterator of fixed-shape numpy batches with a background prefetch
    thread. `decoded` counts the images each decoder served: "dpt_native",
    "pillow" (first tries the native decoder failed, or every image without
    it), "resampled" (an unreadable image replaced from the pool) and
    "zeros" (the pool ran dry)."""

    def __init__(
        self,
        columns: Dict[str, List[str]],          # {'image': paths, 'caption': strs}
        batch_size: int,
        resolution: int = 256,
        tokenize_clip: Optional[Callable[[List[str]], np.ndarray]] = None,
        tokenize_mpnet: Optional[Callable[[List[str]], Dict[str, np.ndarray]]] = None,
        train: bool = True,
        center_crop: bool = False,
        random_flip: bool = True,
        seed: int = 0,
        max_samples: Optional[int] = None,
        prefetch: int = 2,
        use_native: Optional[bool] = None,   # None = when dpt_native imports
        native_threads: int = 0,             # 0 = hardware concurrency
        rows: Optional[slice] = None,        # a data-parallel rank's rows of each batch
    ):
        self.images = columns["image"][:max_samples] if max_samples else columns["image"]
        self.captions = columns["caption"][:max_samples] if max_samples else columns["caption"]
        self.batch_size = batch_size
        self.resolution = resolution
        self.tokenize_clip = tokenize_clip
        self.tokenize_mpnet = tokenize_mpnet
        self.train = train
        self.center_crop = center_crop
        self.random_flip = random_flip
        self.seed = seed
        self.prefetch = prefetch
        self.native = native_decoder()
        self.use_native = (self.native is not None) if use_native is None else use_native
        if self.use_native and self.native is None:
            raise ImportError("use_native=True, but dpt_native does not import "
                              "(python native/setup.py build_ext --inplace)")
        self.native_threads = native_threads
        self.rows = range(batch_size)[rows] if rows is not None else None
        self.decoded: collections.Counter = collections.Counter()
        self._count_lock = threading.Lock()

    def __len__(self):
        return len(self.images) // self.batch_size

    def _count(self, counts: Dict[str, int]) -> None:
        with self._count_lock:
            self.decoded.update(counts)

    def _native_decode(self, idxs: List[int], rng: np.random.RandomState):
        """Batch decode through the C++ thread pool → (pixels, ok); the
        failed entries go to Pillow."""
        raws = []
        for i in idxs:
            try:
                raws.append(read_image_bytes(self.images[i]))
            except (OSError, KeyError):
                raws.append(b"")
        n = len(idxs)
        if self.train and not self.center_crop:
            fx = rng.rand(n).tolist()
            fy = rng.rand(n).tolist()
        else:
            fx = [0.5] * n
            fy = [0.5] * n
        flips = ((rng.rand(n) < 0.5).astype(np.int64).tolist()
                 if (self.train and self.random_flip) else [0] * n)
        batch, ok = self.native.decode_batch(raws, self.resolution, fx, fy,
                                             list(map(int, flips)), self.native_threads)
        return batch, ok.astype(bool)

    def _load(self, i: int, rng: np.random.RandomState) -> Optional[np.ndarray]:
        return load_and_transform_image(self.images[i], self.resolution, self.train,
                                        self.center_crop, self.random_flip, rng)

    def _skip(self, i: int, rng: np.random.RandomState) -> bool:
        return skip_image(self.images[i], self.resolution, self.train, self.center_crop,
                          self.random_flip, rng)

    def _make_batch(self, idxs: Sequence[int], rng: np.random.RandomState,
                    pool: Sequence[int]) -> Dict[str, np.ndarray]:
        idxs = list(idxs)
        backup = list(pool)
        counts: collections.Counter = collections.Counter()
        if self.use_native:
            pixels_arr, ok = self._native_decode(idxs, rng)
            pixels = [pixels_arr[j] if ok[j] else None for j in range(len(idxs))]
            counts["dpt_native"] += int(ok.sum())
        else:
            pixels = [None] * len(idxs)
        caps = [None] * len(idxs)
        mine = range(len(idxs)) if self.rows is None or self.use_native else self.rows
        for j, i in enumerate(idxs):
            if j not in mine:  # another rank's row: its draws and replacements only
                ok = self._skip(i, rng)
                while not ok and backup:
                    ok = self._skip(backup.pop(), rng)
                continue
            arr = pixels[j]
            if arr is None:
                arr = self._load(i, rng)
                if arr is not None:
                    counts["pillow"] += 1
            # static shapes: resample a replacement instead of dropping
            while arr is None and backup:
                i = backup.pop()
                arr = self._load(i, rng)
                if arr is not None:
                    counts["resampled"] += 1
            if arr is None:
                arr = np.zeros((self.resolution, self.resolution, 3), np.float32)
                counts["zeros"] += 1
            pixels[j] = arr
            caps[j] = self.captions[i]
        if self.rows is not None:
            pixels = [pixels[j] for j in self.rows]
            caps = [caps[j] for j in self.rows]
        self._count(counts)
        batch: Dict[str, np.ndarray] = {
            "pixel_values": np.stack(pixels),
            "captions": np.asarray(caps, dtype=object),
        }
        if self.tokenize_clip is not None:
            batch["input_ids"] = self.tokenize_clip(caps)
        if self.tokenize_mpnet is not None:
            batch.update(self.tokenize_mpnet(caps))
        return batch

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        idx = np.arange(len(self.images))
        if self.train:
            np.random.RandomState(self.seed + epoch).shuffle(idx)
        return idx

    def epoch(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        idx = self._epoch_indices(epoch)
        rng = np.random.RandomState(self.seed * 7919 + epoch)
        n = len(idx) // self.batch_size
        q: "queue_mod.Queue" = queue_mod.Queue(maxsize=self.prefetch)
        stop = object()
        abandoned = threading.Event()

        def producer():
            try:
                for b in range(n):
                    lo, hi = b * self.batch_size, (b + 1) * self.batch_size
                    batch = self._make_batch(idx[lo:hi], rng, idx[hi:hi + BACKUP_POOL])
                    while not abandoned.is_set():  # the consumer may walk away
                        try:
                            q.put(batch, timeout=0.5)
                            break
                        except queue_mod.Full:
                            continue
                    if abandoned.is_set():
                        return
                q.put(stop)
            except Exception as e:  # raised again in the consumer's thread
                q.put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            abandoned.set()


def filter_dataset(
    captions: Sequence[str],
    embed_fn: Callable[[List[str]], np.ndarray],     # captions → MPNet embeddings
    route_fn: Callable[[np.ndarray], np.ndarray],    # embeddings → expert indices
    batch_size: int = 2048,
) -> np.ndarray:
    """Assign every caption to its expert, `batch_size` captions at a time."""
    out = []
    for i in range(0, len(captions), batch_size):
        emb = embed_fn(list(captions[i:i + batch_size]))
        out.append(np.asarray(route_fn(emb)))
    return np.concatenate(out) if out else np.zeros((0,), np.int32)
