"""The port's data layer (`diffusion_pruning_tpu_torch/data/`) and the
entry points that read a dataset folder, held against the JAX package and
`transformers` on the CPU. Every test writes its own image folders, tar
shards and tokenizer files."""
import collections
import functools
import io
import json
import math
import os
import string
import tarfile
import unicodedata

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import regex
import torch
import yaml
from hypothesis import HealthCheck, given, settings, strategies as st
from PIL import Image
from safetensors.torch import save_file
from transformers import CLIPTokenizer as HFCLIPTokenizer
from transformers import MPNetTokenizer as HFMPNetTokenizer
from transformers import MPNetTokenizerFast as HFMPNetTokenizerFast
from transformers.models.clip.tokenization_clip import bytes_to_unicode

from diffusion_pruning_tpu.core.estimators import FIXED_KEY, sample_gumbel as jax_sample_gumbel
from diffusion_pruning_tpu.core.structure import build_structure as jax_build_structure
from diffusion_pruning_tpu.data import datasets as jax_datasets
from diffusion_pruning_tpu.data import latent_cache as jax_latent_cache
from diffusion_pruning_tpu.data import loader as jax_loader
from diffusion_pruning_tpu.data import tokenizers as jax_tokenizers
from diffusion_pruning_tpu.data.dummy_tokenizer import DummyTokenizer as JaxDummyTokenizer
from diffusion_pruning_tpu.models import text_encoders as jax_te
from diffusion_pruning_tpu.models.hypernet import HyperStructure as JaxHyperStructure
from diffusion_pruning_tpu.models.quantizer import StructureQuantizer as JaxQuantizer
from diffusion_pruning_tpu.models.unet.config import UNetConfig as JaxUNetConfig
from diffusion_pruning_tpu.models.vae import AutoencoderKL as JaxVAE
from diffusion_pruning_tpu.models.vae import VAEConfig as JaxVAEConfig
from diffusion_pruning_tpu.utils import checkpoint as jax_checkpoint
from diffusion_pruning_tpu_torch import data as port_data
from diffusion_pruning_tpu_torch.cli import cache_latents, filter_dataset, finetune
from diffusion_pruning_tpu_torch.cli import finetune_baseline, prune
from diffusion_pruning_tpu_torch.core.structure import build_structure
from diffusion_pruning_tpu_torch.data import datasets, latent_cache, loader, tokenizers
from diffusion_pruning_tpu_torch.data.dummy_tokenizer import DummyTokenizer
from diffusion_pruning_tpu_torch.models import text_encoders as te
from diffusion_pruning_tpu_torch.models.convert import params_from_jax
from diffusion_pruning_tpu_torch.models.hypernet import HyperStructure
from diffusion_pruning_tpu_torch.models.quantizer import StructureQuantizer
from diffusion_pruning_tpu_torch.models.unet.config import UNetConfig
from diffusion_pruning_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from diffusion_pruning_tpu_torch.training import loop as loop_module
from diffusion_pruning_tpu_torch.training.loop import LoopConfig
from diffusion_pruning_tpu_torch.utils import checkpoint

from torch_port_common import numpy_params

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRUNE_YAML = os.path.join(REPO, "configs", "pruning", "tiny_smoke.yaml")
FINETUNE_YAML = os.path.join(REPO, "configs", "finetuning", "tiny_smoke.yaml")

CAPTIONS = [
    "A photo of a Cat sitting on the RED table!!",
    "wow?? isn't it a dog's life :) they're here, we'll see, I'm sure, he'd go",
    "Café naïve résumé über Ångström — 東京 and 北京 in 2024",
    "12345 people in 2 cities, 3.5 km² at 10:30 p.m.",
    "",
    " ".join(["painting of a street at night"] * 20),   # more than 75 tokens
    "hello<|endoftext|>world! she'S <s> HI <mask> ok",
    "x!y !! ! ,,.. \t new\nline   spaces",
]
WORDS = ("a photo of the cat dog sitting on red blue green table with two people street city "
         "night painting portrait man woman isn't don't we're they've i'm we'll he'd cafe naive "
         "resume uber hello world wow smile 12 345").split()


# ---------------------------------------------------------------- file writers

def bpe_merges(words, n):
    """A byte-level BPE merge list learnt from `words` (most frequent pair
    first, ties by pair order)."""
    b2u = bytes_to_unicode()
    corpus = collections.Counter()
    for w in words:
        m = "".join(b2u[b] for b in w.encode())
        corpus[tuple(m[:-1]) + (m[-1] + "</w>",)] += 1
    merges = []
    for _ in range(n):
        pairs = collections.Counter()
        for word, c in corpus.items():
            for p in zip(word, word[1:]):
                pairs[p] += c
        if not pairs:
            break
        best = max(sorted(pairs), key=lambda p: pairs[p])
        merges.append(best)
        merged = collections.Counter()
        for word, c in corpus.items():
            out, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and (word[i], word[i + 1]) == best:
                    out.append(word[i] + word[i + 1])
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            merged[tuple(out)] += c
        corpus = merged
    return merges


def _added(content):
    return {"content": content, "lstrip": False, "normalized": True, "rstrip": False,
            "single_word": False}


def write_clip_tokenizer(folder, pad="!", small=False):
    """SD-2.1's tokenizer folder layout (vocab.json, merges.txt with its
    version line, special_tokens_map.json, tokenizer_config.json). `small`:
    lower-case letters, digits and a little punctuation only (ids < 128, for
    the tiny text encoder); the rest maps to the unknown token."""
    os.makedirs(folder, exist_ok=True)
    b2u = bytes_to_unicode()
    chars = ([b2u[b] for b in (string.ascii_lowercase + string.digits + "!.,'").encode()]
             if small else list(b2u.values()))
    vocab = chars + [c + "</w>" for c in chars]
    merges = [m for m in bpe_merges(WORDS, 12 if small else 200)
              if all(ch in chars or ch == "</w>" for part in m for ch in [part[0]])]
    for a, b in merges:
        if a + b not in vocab:
            vocab.append(a + b)
    vocab += ["<|startoftext|>", "<|endoftext|>"]
    with open(os.path.join(folder, "vocab.json"), "w") as f:
        json.dump({t: i for i, t in enumerate(vocab)}, f)
    with open(os.path.join(folder, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    with open(os.path.join(folder, "special_tokens_map.json"), "w") as f:
        json.dump({"bos_token": _added("<|startoftext|>"), "eos_token": _added("<|endoftext|>"),
                   "pad_token": pad, "unk_token": _added("<|endoftext|>")}, f)
    with open(os.path.join(folder, "tokenizer_config.json"), "w") as f:
        json.dump({"do_lower_case": True, "model_max_length": 77, "errors": "replace",
                   "pad_token": "<|endoftext|>", "tokenizer_class": "CLIPTokenizer",
                   "bos_token": _added("<|startoftext|>"), "eos_token": _added("<|endoftext|>"),
                   "unk_token": _added("<|endoftext|>")}, f)
    return len(vocab)


def write_mpnet_vocab(folder, small=False):
    """all-mpnet-base-v2's tokenizer files: vocab.txt (special tokens first),
    special_tokens_map.json (`<mask>` strips left), tokenizer_config.json.
    `small`: ids < 128, for the tiny MPNet."""
    os.makedirs(folder, exist_ok=True)
    vocab = ["<s>", "<pad>", "</s>", "<unk>", "[UNK]"]
    vocab += list(string.ascii_lowercase + string.digits) + ["!", ",", ".", "'", "?"]
    vocab += ["##" + c for c in string.ascii_lowercase]
    for w in WORDS[: 20 if small else None]:
        for p in tokenizers.basic_tokenize(w):
            if p not in vocab:
                vocab.append(p)
    if not small:
        vocab += list(string.punctuation) + ["##ing", "##s", "##ed", "東", "京", "北", "km"]
    vocab.append("<mask>")
    vocab = list(dict.fromkeys(vocab))
    with open(os.path.join(folder, "vocab.txt"), "w") as f:
        f.write("\n".join(vocab) + "\n")
    with open(os.path.join(folder, "special_tokens_map.json"), "w") as f:
        json.dump({"bos_token": "<s>", "cls_token": "<s>", "eos_token": "</s>",
                   "mask_token": {"content": "<mask>", "lstrip": True, "normalized": False,
                                  "rstrip": False, "single_word": False},
                   "pad_token": "<pad>", "sep_token": "</s>", "unk_token": "[UNK]"}, f)
    with open(os.path.join(folder, "tokenizer_config.json"), "w") as f:
        json.dump({"do_lower_case": True, "model_max_length": 384, "strip_accents": None,
                   "tokenize_chinese_chars": True, "tokenizer_class": "MPNetTokenizer"}, f)
    return len(vocab)


def _jpeg(rng, w, h):
    """A smooth field plus noise, as JPEG bytes."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255.0 / w, yy * 255.0 / h, (xx + yy) * 127.0 / (w + h)], -1)
    img = np.clip(base + rng.normal(0, 12, base.shape), 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=90)
    return buf.getvalue()


def caption(rng):
    return " ".join(rng.choice(WORDS, size=rng.integers(3, 9)))


def write_coco(root, n_train=12, n_val=4, sizes=((48, 36), (36, 48)), corrupt=(), missing=(),
               seed=0):
    """COCO-2014's layout: images/{train,val}2014/COCO_{split}2014_{id:012d}.jpg
    and annotations/captions_{split}2014.json. `corrupt` train ids get bytes
    that are no JPEG, `missing` ones no file."""
    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        img_dir = os.path.join(root, "images", f"{split}2014")
        os.makedirs(img_dir, exist_ok=True)
        ann = {"annotations": []}
        for i in range(n):
            path = os.path.join(img_dir, f"COCO_{split}2014_{i:012d}.jpg")
            if not (split == "train" and i in missing):
                with open(path, "wb") as f:
                    bad = split == "train" and i in corrupt
                    f.write(b"not a jpeg" if bad else _jpeg(rng, *sizes[i % len(sizes)]))
            ann["annotations"].append({"image_id": i, "caption": caption(rng)})
        os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
        with open(os.path.join(root, "annotations", f"captions_{split}2014.json"), "w") as f:
            json.dump(ann, f)
    return str(root)


def write_cc3m_tsv(root, n=8):
    rng = np.random.default_rng(1)
    for split, tsv, sub in (("train", "Train_GCC-training.tsv", "training"),
                            ("validation", "Validation_GCC-1.1.0-Validation.tsv",
                             "validation")):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        with open(os.path.join(root, tsv), "w") as f:
            for i in range(n):
                f.write(f"{caption(rng)}\thttp://example.invalid/{i}\n")
        for i in range(0, n, 2):  # only some downloads succeeded
            with open(os.path.join(root, sub, f"{i}_abcdef.jpg"), "wb") as f:
                f.write(_jpeg(rng, 40, 32))
    return str(root)


def write_cc3m_wds(root, shards=2, per_shard=4):
    rng = np.random.default_rng(2)
    k = 0
    for sub in ("training", "validation"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        for shard in range(shards):
            with tarfile.open(os.path.join(root, sub, f"{shard:05d}.tar"), "w") as tf:
                for _ in range(per_shard):
                    for name, data in ((f"{k:06d}.jpg", _jpeg(rng, 40, 30)),
                                       (f"{k:06d}.txt", caption(rng).encode())):
                        info = tarfile.TarInfo(name)
                        info.size = len(data)
                        tf.addfile(info, io.BytesIO(data))
                    k += 1
    return str(root)


class _DataCfg:
    def __init__(self, data_dir, dataset_name):
        self.data_dir, self.dataset_name, self.year = data_dir, dataset_name, 2014


# ---------------------------------------------------------------- tokenizers

@pytest.fixture(scope="module")
def clip_folders(tmp_path_factory):
    root = tmp_path_factory.mktemp("clip")
    out = {}
    for name, pad in (("bang", "!"), ("eot", "<|endoftext|>")):
        write_clip_tokenizer(str(root / name), pad=pad)
        out[name] = (tokenizers.CLIPTokenizer(str(root / name)),
                     HFCLIPTokenizer.from_pretrained(str(root / name)))
    return out


@pytest.fixture(scope="module")
def mpnet_folder(tmp_path_factory):
    folder = str(tmp_path_factory.mktemp("mpnet"))
    write_mpnet_vocab(folder)
    return (tokenizers.MPNetTokenizer(folder), HFMPNetTokenizer.from_pretrained(folder),
            HFMPNetTokenizerFast.from_pretrained(folder))


def _encode(tok, texts, max_length):
    enc = tok(texts, max_length=max_length, padding="max_length", truncation=True,
              return_tensors="np")
    return np.asarray(enc.input_ids), np.asarray(enc.attention_mask)


@pytest.mark.parametrize("pad", ["bang", "eot"])
def test_clip_bpe_matches_transformers_on_fixed_captions(clip_folders, pad):
    """Ids and masks of `transformers.CLIPTokenizer` (no ftfy) built from the
    same files; SD-2.1 pads with "!" (id 0), which is also split out of the
    text as a special token, so "!!" is two tokens there and one BPE word
    with <|endoftext|> padding."""
    ours, ref = clip_folders[pad]
    got_ids, got_mask = _encode(ours, CAPTIONS, 77)
    want_ids, want_mask = _encode(ref, CAPTIONS, 77)
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_array_equal(got_mask, want_mask)
    assert ours.special_id("pad_token") == ref.pad_token_id == (0 if pad == "bang" else
                                                               ref.eos_token_id)
    assert got_ids[0, -1] == ref.pad_token_id and got_mask[5].all()  # padded; truncated
    assert ours.tokenize("hello!! wow") == ref.tokenize("hello!! wow")


@settings(max_examples=150, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(text=st.text(max_size=60))
def test_clip_bpe_matches_transformers_on_random_text(clip_folders, text):
    ours, ref = clip_folders["bang"]
    for a, b in zip(_encode(ours, [text], 77), _encode(ref, [text], 77)):
        np.testing.assert_array_equal(a, b)


def test_clip_pattern_classes_match_the_regex_package():
    """CLIP's split pattern in the stdlib `re` (letter and number classes
    from `unicodedata`) finds what the `regex` package's `\\p{L}`/`\\p{N}`
    pattern finds, for every assigned code point that survives the cleaning
    (no control or format character, no whitespace), alone and beside a
    letter and an apostrophe."""
    ref = regex.compile(r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
                        r"""[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""", regex.IGNORECASE)
    ours = tokenizers.clip_pattern()
    bad = []
    for cp in range(0x110000):
        ch = chr(cp)
        if unicodedata.category(ch)[0] == "C" or ch.isspace():
            continue
        for probe in (ch, "a" + ch + "1", "'" + ch):
            if ours.findall(probe.translate(tokenizers._CLIP_SEPARATORS)) != ref.findall(probe):
                bad.append(hex(cp))
                break
    assert bad == []


@pytest.mark.parametrize("max_length", [128, 64])
def test_mpnet_wordpiece_matches_transformers_on_fixed_captions(mpnet_folder, max_length):
    """Ids and masks of `MPNetTokenizer` and `MPNetTokenizerFast` from the same
    vocab.txt: lower case, accents stripped, CJK split, `##` pieces, special
    tokens kept (`<mask>` takes the space before it). Upper-case special
    tokens ("<S>") are lower-cased into special tokens by `MPNetTokenizer`
    only: the fast tokenizer matches them before lower-casing."""
    ours, slow, fast = mpnet_folder
    texts = CAPTIONS + ["x" * 120 + " long words become [UNK]", "spaced   <mask> out"]
    got = _encode(ours, texts, max_length)
    for ref in (slow, fast):
        for a, b in zip(got, _encode(ref, texts, max_length)):
            np.testing.assert_array_equal(a, b)
    upper = ["<S> HI <MASK> there", "<PAD>"]
    for a, b in zip(_encode(ours, upper, max_length), _encode(slow, upper, max_length)):
        np.testing.assert_array_equal(a, b)


@settings(max_examples=150, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(text=st.text(max_size=60))
def test_mpnet_wordpiece_matches_the_slow_tokenizer_on_random_text(mpnet_folder, text):
    ours, slow, _ = mpnet_folder
    for a, b in zip(_encode(ours, [text], 64), _encode(slow, [text], 64)):
        np.testing.assert_array_equal(a, b)


# the Rust tokenizer behind MPNetTokenizerFast keeps unassigned code points
# and reads some characters of newer Unicode versions otherwise than Python's
# unicodedata (and so MPNetTokenizer); these blocks read alike in all three
_OLD_BLOCKS = st.one_of(*[
    st.characters(min_codepoint=lo, max_codepoint=hi, exclude_categories=("Cs", "Cn"))
    for lo, hi in ((0x0, 0x24F), (0x370, 0x4FF), (0x2000, 0x206F), (0x3040, 0x30FF),
                   (0x4E00, 0x9FA5))])


@settings(max_examples=150, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(text=st.text(alphabet=_OLD_BLOCKS, max_size=60))
def test_mpnet_wordpiece_matches_the_fast_tokenizer_on_random_text(mpnet_folder, text):
    ours, _, fast = mpnet_folder
    for a, b in zip(_encode(ours, [text], 64), _encode(fast, [text], 64)):
        np.testing.assert_array_equal(a, b)


def test_hash_tokenizer_equals_jax():
    texts = ["a red cat", "", "one two three four five six seven eight nine ten eleven"]
    for vocab, length in ((128, 77), (30527, 8)):
        ours = DummyTokenizer(vocab_size=vocab, max_length=length)(texts)
        want = JaxDummyTokenizer(vocab_size=vocab, max_length=length)(texts)
        np.testing.assert_array_equal(ours.input_ids, want.input_ids)
        np.testing.assert_array_equal(ours["attention_mask"], want["attention_mask"])


def test_tokenizer_builders_read_the_folders_or_fall_back(tmp_path, capsys):
    sd_root = tmp_path / "sd"
    assert isinstance(tokenizers.build_clip_tokenizer(str(sd_root), vocab_size=99),
                      DummyTokenizer)
    assert isinstance(tokenizers.build_mpnet_tokenizer(str(tmp_path / "mp"), vocab_size=99),
                      DummyTokenizer)
    err = capsys.readouterr().err
    assert "[smoke] CLIP tokenizer" in err and "[smoke] MPNet tokenizer" in err
    write_clip_tokenizer(str(sd_root / "tokenizer"))
    write_mpnet_vocab(str(tmp_path / "mp"))
    clip = tokenizers.build_clip_tokenizer(str(sd_root))
    mp = tokenizers.build_mpnet_tokenizer(str(tmp_path / "mp"), vocab_size=99)
    want_clip = jax_tokenizers.build_clip_tokenizer(str(sd_root))
    want_mp = jax_tokenizers.build_mpnet_tokenizer(str(tmp_path / "mp"), vocab_size=99)
    for ours, ref, length in ((clip, want_clip, 77), (mp, want_mp, 128)):
        for a, b in zip(_encode(ours, CAPTIONS, length), _encode(ref, CAPTIONS, length)):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- datasets

@pytest.mark.parametrize("layout", ["coco", "cc3m_tsv", "cc3m_wds"])
def test_get_dataset_gives_the_jax_columns(tmp_path, layout):
    if layout == "coco":
        cfg = _DataCfg(write_coco(tmp_path / "coco"), "coco")
    elif layout == "cc3m_tsv":
        cfg = _DataCfg(write_cc3m_tsv(tmp_path / "cc3m"), "cc3m")
    else:
        cfg = _DataCfg(write_cc3m_wds(tmp_path / "cc3m"), "cc3m")
    got = port_data.get_dataset(cfg)
    for f in os.listdir(cfg.data_dir):  # each package writes its own name caches
        if f.endswith(".pkl"):
            os.remove(os.path.join(cfg.data_dir, f))
    want = jax_datasets.get_dataset(cfg)
    assert got == want and len(got["train"]["image"]) > 0
    shard = datasets.shard_by_process(got["train"], 1, 2)
    assert shard == jax_datasets.shard_by_process(want["train"], 1, 2)


# ---------------------------------------------------------------- loader

def _tok(caps):
    return np.asarray([[len(c), sum(map(ord, c)) % 997] for c in caps], np.int64)


def _tok_mp(caps):
    return {"mpnet_input_ids": _tok(caps), "mpnet_attention_mask": np.ones((len(caps), 2))}


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("native", [False, True], ids=["pillow", "dpt_native"])
@pytest.mark.parametrize("case", ["train", "eval", "corrupt", "wds"])
def test_data_pipeline_batches_equal_jax_bit_for_bit(tmp_path, case, native):
    """The same folder, seed and settings: the port's batches are the JAX
    loader's, key for key and bit for bit, over two epochs (shuffle, crops
    and flips, resampling of unreadable files, `shard.tar::member` specs)."""
    if native:
        pytest.importorskip("dpt_native")
    if case == "wds":
        cols = datasets.load_cc3m_webdataset(write_cc3m_wds(tmp_path / "cc3m"), "training")
    else:
        root = write_coco(tmp_path / "coco", n_train=14,
                          corrupt=(1, 4) if case == "corrupt" else (),
                          missing=(6,) if case == "corrupt" else ())
        cols = datasets.load_coco_dataset(os.path.join(root, "images", "train2014"),
                                          os.path.join(root, "annotations",
                                                       "captions_train2014.json"))
    kw = dict(batch_size=3, resolution=32, tokenize_clip=_tok, tokenize_mpnet=_tok_mp,
              train=case != "eval", seed=5, use_native=native)
    ours = loader.DataPipeline(cols, **kw)
    ref = jax_loader.DataPipeline(cols, **kw)
    for epoch in (0, 1):
        _assert_batches_equal(list(ours.epoch(epoch)), list(ref.epoch(epoch)))
    served = sum(ours.decoded.values())
    assert served == 2 * len(ours) * 3
    if case == "corrupt":
        assert ours.decoded["resampled"] > 0 and ours.decoded["zeros"] == 0
    else:
        assert ours.decoded["dpt_native" if native else "pillow"] == served


def test_data_pipeline_center_crop_without_flip_equals_jax(tmp_path):
    root = write_coco(tmp_path / "coco", n_train=6)
    cols = port_data.get_dataset(_DataCfg(root, "coco"))["train"]
    kw = dict(batch_size=2, resolution=24, train=True, center_crop=True, random_flip=False,
              seed=1, use_native=False, max_samples=5)
    _assert_batches_equal(list(loader.DataPipeline(cols, **kw).epoch(0)),
                          list(jax_loader.DataPipeline(cols, **kw).epoch(0)))


def test_data_pipeline_abandoned_and_failing_epochs(tmp_path):
    """A consumer that stops early leaves no producer behind it; a producer's
    error reaches the consumer."""
    import threading
    root = write_coco(tmp_path / "coco", n_train=12)
    cols = port_data.get_dataset(_DataCfg(root, "coco"))["train"]
    pipe = loader.DataPipeline(cols, batch_size=2, resolution=16, use_native=False, prefetch=1)
    before = threading.active_count()
    it = pipe.epoch(0)
    next(it)
    it.close()
    for _ in range(50):
        if threading.active_count() <= before:
            break
        threading.Event().wait(0.1)
    assert threading.active_count() <= before

    def broken(caps):
        raise RuntimeError("tokenizer failed")

    bad = loader.DataPipeline(cols, batch_size=2, resolution=16, tokenize_clip=broken,
                              use_native=False)
    with pytest.raises(RuntimeError, match="tokenizer failed"):
        list(bad.epoch(0))


def test_native_decoder_matches_pillow(tmp_path):
    """dpt_native against the Pillow path on one smooth image (the JAX
    package's test of its loader, on the port's): PIL's resize is
    anti-aliased and the native path DCT-prescales then interpolates, so the
    two agree loosely."""
    dpt_native = pytest.importorskip("dpt_native")
    yy, xx = np.mgrid[0:80, 0:120]
    smooth = np.stack([yy * 2, xx * 1.5, (yy + xx)], -1).astype(np.uint8)
    path = tmp_path / "x.jpg"
    Image.fromarray(smooth).save(path, quality=98)
    pil = loader.load_and_transform_image(str(path), 32, train=False, center_crop=True,
                                          random_flip=False, rng=np.random.RandomState(0))
    batch, ok = dpt_native.decode_batch([path.read_bytes()], 32, [0.5], [0.5], [0], 1)
    assert ok[0] == 1
    assert np.abs(batch[0] - pil).mean() < 0.02
    root = write_coco(tmp_path / "coco", n_train=4)
    cols = port_data.get_dataset(_DataCfg(root, "coco"))["train"]
    a = loader.DataPipeline(cols, batch_size=2, resolution=32, train=False, use_native=True)
    b = loader.DataPipeline(cols, batch_size=2, resolution=32, train=False, use_native=False)
    xa = next(iter(a.epoch(0)))["pixel_values"]
    xb = next(iter(b.epoch(0)))["pixel_values"]
    assert np.abs(xa - xb).mean() < 0.05
    assert set(a.decoded) == {"dpt_native"} and set(b.decoded) == {"pillow"}


def test_filter_dataset_batches_as_jax():
    calls = []

    def embed(caps):
        calls.append(len(caps))
        return np.arange(len(caps), dtype=np.float32)[:, None]

    def route(emb):
        return (emb[:, 0] % 3).astype(np.int32)

    caps = [f"c{i}" for i in range(10)]
    got = loader.filter_dataset(caps, embed, route, batch_size=4)
    np.testing.assert_array_equal(got, jax_loader.filter_dataset(caps, embed, route, 4))
    assert calls == [4, 4, 2, 4, 4, 2]
    assert loader.filter_dataset([], embed, route).shape == (0,)


# ---------------------------------------------------------------- routing

def _carry(jax_module, port_module, *init_args, seed=0):
    shapes = jax.eval_shape(lambda: jax_module.init(jax.random.PRNGKey(0), *init_args))
    params = numpy_params(shapes["params"], seed)
    port_module.load_state_dict(params_from_jax(params, port_module))
    return params


def test_filter_dataset_indices_equal_jax(tmp_path):
    """MPNet → mean pool → hypernet → cosine index against the snapshot, with
    the same weights, tokenizer files and captions in both packages (the
    JAX router's FIXED_KEY noise passed to the port's), and the indices file
    read back by both packages' `load_torch_artifact`."""
    folder = str(tmp_path / "mpnet")
    write_mpnet_vocab(folder, small=True)
    rng = np.random.default_rng(3)
    caps = [caption(rng) for _ in range(40)]
    mcfg = te.MPNetConfig.tiny()
    jmp = jax_te.MPNetEncoder(jax_te.MPNetConfig.tiny())
    mp = te.MPNetEncoder(mcfg).eval()
    mp_params = _carry(jmp, mp, jnp.zeros((1, 8), jnp.int32), jnp.ones((1, 8), jnp.int32))
    jspec = jax_build_structure(JaxUNetConfig.tiny())
    jhn = JaxHyperStructure(jspec, input_dim=mcfg.hidden_size)
    hn = HyperStructure(build_structure(UNetConfig.tiny()), input_dim=mcfg.hidden_size)
    hn_params = _carry(jhn, hn, jnp.zeros((1, mcfg.hidden_size)), seed=1)
    jq = JaxQuantizer(jspec, n_e=4, base=0.0)
    jq_params = jax.jit(jq.init_params)(jax.random.PRNGKey(4))
    jstate = jax.jit(jq.init_state)(jq_params)
    q = StructureQuantizer(build_structure(UNetConfig.tiny()), n_e=4, base=0.0)
    q.load_state_dict(params_from_jax({"embedding": np.asarray(jq_params["embedding"]),
                                       "embedding_gs": np.asarray(jstate["embedding_gs"])}, q))

    jtok = jax_tokenizers.build_mpnet_tokenizer(folder, vocab_size=mcfg.vocab_size)
    length = min(jax_te.MPNET_MAX_LEN, mcfg.max_positions)
    mp_fwd = jax_te.jit_sentence_embed(jmp)

    def jax_embed(c):
        enc = jtok(c, padding="max_length", max_length=length, truncation=True,
                   return_tensors="np")
        return np.asarray(mp_fwd(mp_params, jnp.asarray(enc["input_ids"]),
                                 jnp.asarray(enc["attention_mask"])))

    def jax_route(emb):
        logits = jhn.apply({"params": hn_params}, jnp.asarray(emb))
        return jq.cosine_indices(logits, jstate["embedding_gs"], key=None)

    want = jax_loader.filter_dataset(caps, jax_embed, jax_route)
    kw, kd = jax.random.split(FIXED_KEY)
    noise = torch.from_numpy(np.concatenate(
        [np.asarray(jax_sample_gumbel(kw, (len(caps), jspec.num_width))),
         np.asarray(jax_sample_gumbel(kd, (len(caps), jspec.num_depth)))], axis=1))
    embed = filter_dataset.caption_embedder(mp, tokenizers.build_mpnet_tokenizer(
        folder, vocab_size=mcfg.vocab_size))
    np.testing.assert_allclose(embed(caps).numpy(), jax_embed(caps), rtol=1e-4, atol=1e-5)
    got = filter_dataset.route_captions(caps, embed, hn, q, noise=noise)
    assert got.dtype == np.int64 and len(set(got.tolist())) > 1
    np.testing.assert_array_equal(got, np.asarray(want))
    path = str(tmp_path / "coco_train_mapped_indices.pt")
    checkpoint.save_torch_artifact(got, path)
    for load in (checkpoint.load_torch_artifact, jax_checkpoint.load_torch_artifact):
        back = np.asarray(load(path))
        assert back.dtype == np.int64
        np.testing.assert_array_equal(back, got)


# ---------------------------------------------------------------- latent cache

def test_latent_cache_shards_and_batches_agree_with_jax(tmp_path):
    """Shards of the same deterministic pipeline, encoded by the port's VAE
    and by the JAX VAE with the same weights, agree within one f16 step
    (plus the f32 slack of the two encoders);
    each package's `LatentPipeline` reads either package's shards into equal
    batches (order, flips, captions)."""
    root = write_coco(tmp_path / "coco", n_train=10, sizes=((40, 30),))
    cols = port_data.get_dataset(_DataCfg(root, "coco"))["train"]
    jvae = JaxVAE(JaxVAEConfig.tiny())
    vae = AutoencoderKL(VAEConfig.tiny()).eval()
    params = _carry(jvae, vae, jnp.zeros((1, 16, 16, 3)), jax.random.PRNGKey(0))
    kw = dict(batch_size=4, resolution=16, train=False, center_crop=True, random_flip=False,
              use_native=False)

    @torch.inference_mode()
    def encode(px):
        return vae.encode_moments(px)

    ours = latent_cache.build_latent_cache(loader.DataPipeline(cols, **kw).epoch(0), encode,
                                           str(tmp_path / "port"), shard_size=3)
    jencode = jax.jit(lambda px: jvae.apply({"params": params}, px,
                                            method=JaxVAE.encode_moments))
    theirs = jax_latent_cache.build_latent_cache(jax_loader.DataPipeline(cols, **kw).epoch(0),
                                                 jencode, str(tmp_path / "jax"), shard_size=3)
    assert [os.path.basename(p) for p in ours] == [os.path.basename(p) for p in theirs]
    assert len(ours) == 2
    for a, b in zip(ours, theirs):
        za, zb = np.load(a, allow_pickle=True), np.load(b, allow_pickle=True)
        assert sorted(za.files) == sorted(zb.files) == ["caption", "logvar", "mean"]
        assert za["caption"].tolist() == zb["caption"].tolist()
        for key in ("mean", "logvar"):
            x, y = za[key], zb[key]
            assert x.dtype == y.dtype == np.float16 and x.shape == y.shape
            # one f16 step, plus the f32 slack of the two packages' op orders
            # (a few 1e-7 absolute: two steps of the smallest moments)
            step = np.spacing(np.maximum(np.abs(x), np.abs(y))).astype(np.float32)
            diff = np.abs(x.astype(np.float32) - y.astype(np.float32))
            assert (diff <= step + 1e-5).all() and (diff <= step).mean() > 0.99, key
    for shards in ("port", "jax"):
        for train in (True, False):
            lkw = dict(batch_size=3, train=train, seed=2, tokenize_clip=_tok)
            got = latent_cache.LatentPipeline(str(tmp_path / shards), **lkw)
            want = jax_latent_cache.LatentPipeline(str(tmp_path / shards), **lkw)
            for epoch in (0, 1):
                _assert_batches_equal(list(got.epoch(epoch)), list(want.epoch(epoch)))


# ---------------------------------------------------------------- the slice

def _yaml(src, tmp_path, name, **changes):
    with open(src) as f:
        cfg = yaml.safe_load(f)
    cfg["training"]["logging"]["logging_dir"] = str(tmp_path / "runs")
    for path, value in changes.items():
        node = cfg
        *parents, last = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = value
    out = tmp_path / name
    out.write_text(yaml.safe_dump(cfg, sort_keys=False))
    return str(out)


def write_tiny_checkpoints(root):
    """A checkpoint root with only the CLIP tokenizer (so every model is the
    tiny random one), and an MPNet folder with the tiny MPNet's weights and
    a vocabulary below its 128 ids."""
    assert write_clip_tokenizer(os.path.join(root, "sd", "tokenizer"), small=True) < 128
    mp_dir = os.path.join(root, "mpnet")
    assert write_mpnet_vocab(mp_dir, small=True) < 128
    model = te.MPNetEncoder(te.MPNetConfig.tiny())
    torch.manual_seed(0)
    for p in model.parameters():
        torch.nn.init.normal_(p, std=0.05)
    save_file({k: v.contiguous() for k, v in model.state_dict().items()},
              os.path.join(mp_dir, "model.safetensors"))
    return os.path.join(root, "sd"), mp_dir


def test_the_slice_runs_on_a_dataset_folder(tmp_path, monkeypatch):
    """prune → filter_dataset → finetune (the expert with most captions) →
    finetune_baseline → cache_latents, on one written COCO folder with the
    tiny models and real tokenizer files, `--device cpu`: the files each step
    writes, finite losses, the expert's batches drawn from its rows only,
    the image logger's grids."""
    data_dir = write_coco(tmp_path / "coco", n_train=cache_latents.CACHE_BATCH + 2, n_val=4,
                          sizes=((80, 60), (60, 80)), corrupt=(3,))
    sd_root, mp_dir = write_tiny_checkpoints(str(tmp_path / "ckpt"))
    common = ["--device", "cpu", "--pretrained_model_name_or_path", sd_root,
              "--prompt_encoder_model_name_or_path", mp_dir, "--seed", "0"]
    data = {"data.data_dir": data_dir, "data.dataset_name": "coco", "data.year": 2014}
    monkeypatch.setattr(loop_module, "LoopConfig", functools.partial(LoopConfig, log_every=1))

    # stage 1 with validation and the image logger at step 4
    p_yaml = _yaml(PRUNE_YAML, tmp_path, "p.yaml", **data, **{
        "data.prompts": ["a red cat", "two dogs on a table"], "training.max_train_steps": 4,
        "training.image_logging_steps": 4, "training.validation_steps": 4,
        "training.num_inference_steps": 2})
    loop = prune.main(["--base_config_path", p_yaml, "--wandb_run_name", "p", *common])
    run = loop.run_dir
    assert sorted(os.listdir(os.path.join(run, "samples"))) == [
        "quantizer_samples_4.png", "samples_4.png"]
    grid = np.asarray(Image.open(os.path.join(run, "samples", "samples_4.png")))
    q_grid = np.asarray(Image.open(os.path.join(run, "samples", "quantizer_samples_4.png")))
    res = loop.mods.unet.cfg.sample_size * loop.mods.vae.cfg.spatial_scale
    assert grid.shape == (res, 2 * res, 3) and q_grid.shape == (res, 4 * res, 3)  # 2 prompts, K 4
    assert os.path.exists(os.path.join(run, "heatmaps", "codebook_sim_4.png"))
    with open(os.path.join(run, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    steps = [m for m in lines if "loss" in m]
    assert [m["step"] for m in steps] == [1, 2, 3, 4]
    assert all(math.isfinite(m["loss"]) for m in steps)
    assert any("val_loss" in m and math.isfinite(m["val_loss"]) for m in lines)

    # routing: one int64 index per caption, for both splits
    indices = filter_dataset.main(["--base_config_path", p_yaml, "--pruning_ckpt_dir", run,
                                   *common])
    cols = port_data.get_dataset(_DataCfg(data_dir, "coco"))
    for split in ("train", "validation"):
        saved = checkpoint.load_torch_artifact(os.path.join(
            run, f"coco_{split}_mapped_indices.pt"))
        assert saved.dtype == torch.int64 and len(saved) == len(cols[split]["caption"])
        np.testing.assert_array_equal(saved.numpy(), indices[split])

    # stage 2 for the expert with most train captions, its batches from its rows
    expert = int(np.bincount(indices["train"]).argmax())
    mine = {c for c, e in zip(cols["train"]["caption"], indices["train"]) if e == expert}
    seen = []
    real_batches = finetune.dataset_batches

    def recording(*a, **k):
        train, val = real_batches(*a, **k)

        def train_batches(epoch):
            for b in train(epoch):
                seen.extend(b["captions"].tolist())
                yield b
        return train_batches, val

    monkeypatch.setattr(finetune, "dataset_batches", recording)
    f_yaml = _yaml(FINETUNE_YAML, tmp_path, "f.yaml", **data, **{
        "training.max_train_steps": 2, "training.validation_steps": 2,
        "data.dataloader.train_batch_size": 2})
    ft = finetune.main(["--base_config_path", f_yaml, "--pruning_ckpt_dir", run, "--expert_id",
                        str(expert), "--wandb_run_name", "f", *common])
    # the loop draws one batch past its last step before it stops
    assert ft.global_step == 2 and len(seen) >= 4 and set(seen) <= mine
    assert len(mine) < len(cols["train"]["caption"])
    assert sorted(os.listdir(ft.run_dir)) == ["README.md", "arch_vector.pt", "checkpoint-2",
                                             "config.yaml", "metrics.jsonl", "train.log"]
    with open(os.path.join(ft.run_dir, "metrics.jsonl")) as f:
        ft_lines = [json.loads(line) for line in f]
    assert all(math.isfinite(m["loss"]) for m in ft_lines if "loss" in m)
    assert any("val_loss" in m for m in ft_lines)

    # the baseline trains on every caption
    seen.clear()
    base = finetune_baseline.main(["--base_config_path", f_yaml, "--pruning_type", "magnitude",
                                   *common])
    assert base.global_step == 2 and len(seen) >= 4 and not set(seen) <= mine
    assert os.path.exists(os.path.join(base.run_dir, "checkpoint-2", "arch_vector.pt"))

    # the latent cache: one batch of 32 train images (the validation split
    # fills none), read back as the steps' latent batches
    shards = cache_latents.main(["--base_config_path", p_yaml, "--cache_dir",
                                 str(tmp_path / "latents"), *common])
    assert {k: len(v) for k, v in shards.items()} == {"train": 1, "validation": 0}
    cached = latent_cache.LatentPipeline(str(tmp_path / "latents" / "train"), batch_size=2)
    assert len(cached.captions) == cache_latents.CACHE_BATCH
    batch = next(iter(cached.epoch(0)))
    assert batch["latent_mean"].shape == (2, 8, 8, 4) and np.isfinite(batch["latent_mean"]).all()


def test_new_entry_points_need_a_card_unless_told_cpu(tmp_path, monkeypatch):
    """filter_dataset and cache_latents resolve the card as the other entry
    points do: without one they raise, unless given `--device cpu`."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = _yaml(PRUNE_YAML, tmp_path, "p.yaml", **{
        "data.data_dir": write_coco(tmp_path / "coco", n_train=2, n_val=2),
        "data.dataset_name": "coco"})
    for main, extra in ((filter_dataset.main, ["--pruning_ckpt_dir", str(tmp_path)]),
                        (cache_latents.main, ["--cache_dir", str(tmp_path / "latents")])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--base_config_path", config, "--pretrained_model_name_or_path", "", *extra])
    assert not (tmp_path / "latents").exists()
    with pytest.raises(ValueError, match="--pruning_ckpt_dir"):
        filter_dataset.main(["--base_config_path", config, "--device", "cpu"])
