"""Dataset loaders — counterpart of ``fedml_tpu/data/data_loader.py``.

The numpy code is the reference's, with the same generators, draws and
order, so a port run sees the reference's arrays for the same arguments:
:func:`load_federated` dispatches on ``args.dataset`` to the synthetic,
MNIST, CIFAR-10 and Shakespeare loaders (and the causal-LM streams of the
LLM slice). Each first looks for the real files under
``args.data_cache_dir`` (``mnist.npz`` or the idx files, ``cifar10.npz`` or
the binary batches, LEAF's ``shakespeare_{train,test}.json`` or
``shakespeare.txt``) and otherwise generates a learnable synthetic
stand-in of the real shapes, with a loud warning
(:func:`_synthetic_fallback`). FEMNIST, CIFAR-100 and the
StackOverflow/Reddit loaders come with the rest of the data zoo (ROADMAP
A13): naming one raises.

The synthetic CIFAR seed adds ``hash(name) % 1000``, as the reference's
does; Python salts string hashes per process, so that stand-in differs
from one process to the next (and equals the reference's within one).
"""
from __future__ import annotations

import logging
import os
from typing import Any, Callable, Dict, Tuple

import numpy as np

from fedml_tpu_torch.core.data.noniid_partition import (
    homo_partition,
    non_iid_partition_with_dirichlet_distribution,
    record_data_stats,
)
from fedml_tpu_torch.data.dataset import FederatedDataset

logger = logging.getLogger(__name__)

_LOADERS: Dict[str, Callable] = {}

# loaders of the reference that the port has not ported (ROADMAP A13)
_NOT_PORTED = ("femnist", "cifar100", "fed_cifar100", "stackoverflow_lr",
               "stackoverflow_nwp", "reddit")


def register_dataset(*names: str):
    def deco(fn):
        for n in names:
            _LOADERS[n] = fn
        return fn

    return deco


def load_federated(args: Any) -> FederatedDataset:
    name = str(getattr(args, "dataset", "synthetic")).lower()
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"dataset {name!r} comes with the rest of the data zoo (ROADMAP "
            "A13); the port loads synthetic, synthetic_image, mnist, cifar10, "
            "shakespeare and the LLM streams")
    if name not in _LOADERS:
        _synthetic_fallback(
            name,
            f"unknown dataset name {name!r} (registered: {sorted(_LOADERS)})",
            advice="fix the `dataset:` config value",
        )
        name = "synthetic"
    return _LOADERS[name](args)


def _synthetic_fallback(name: str, reason: str,
                        advice: str = "place the real files under "
                        "args.data_cache_dir") -> None:
    """Loudly record that a run is about to train on synthetic stand-in
    data: a WARNING in the log and a ``data/synthetic_fallback`` count in
    the metrics registry, labelled with the dataset."""
    msg = (f"dataset {name!r}: SYNTHETIC STAND-IN in use — {reason}. "
           f"Accuracy is NOT comparable to the real dataset; {advice} "
           "to silence this.")
    logger.warning(msg)
    from fedml_tpu_torch.telemetry import get_registry

    get_registry().counter("data/synthetic_fallback", {"dataset": name}).inc()


# --------------------------------------------------------------------------
# raw-format readers (the reference's native reader, numpy twin)
# --------------------------------------------------------------------------

def _read_mnist(images_path: str, labels_path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(x [n, 784] float32 in [0, 1], y [n] int32) from raw idx files."""
    with open(images_path, "rb") as f:
        raw = f.read()
    if len(raw) < 16 or int.from_bytes(raw[:4], "big") != 0x803:
        raise ValueError(f"{images_path}: not an idx3 image file")
    n, r, c = (int.from_bytes(raw[o: o + 4], "big") for o in (4, 8, 12))
    x = (np.frombuffer(raw, np.uint8, count=n * r * c, offset=16)
         .astype(np.float32) / 255.0).reshape(n, r * c)
    with open(labels_path, "rb") as f:
        raw = f.read()
    if len(raw) < 8 or int.from_bytes(raw[:4], "big") != 0x801:
        raise ValueError(f"{labels_path}: not an idx1 label file")
    m = int.from_bytes(raw[4:8], "big")
    y = np.frombuffer(raw, np.uint8, count=m, offset=8).astype(np.int32)
    k = min(len(x), len(y))
    return x[:k], y[:k]


def _read_cifar10_batches(paths) -> Tuple[np.ndarray, np.ndarray]:
    """(x [n, 32, 32, 3] float32 HWC in [0, 1], y [n] int32) from binary
    batch files, concatenated in the given order."""
    xs, ys = [], []
    rec = 1 + 3 * 32 * 32
    for path in paths:
        raw = np.fromfile(path, np.uint8)
        n = raw.size // rec
        rows = raw[: n * rec].reshape(n, rec)
        ys.append(rows[:, 0].astype(np.int32))
        chw = rows[:, 1:].reshape(n, 3, 32, 32)
        xs.append(np.transpose(chw, (0, 2, 3, 1)).astype(np.float32) / 255.0)
    return np.concatenate(xs), np.concatenate(ys)


# --------------------------------------------------------------------------
# synthetic class-structured generator (shared machinery)
# --------------------------------------------------------------------------

def _make_classification_arrays(
    n_train: int,
    n_test: int,
    feature_shape: Tuple[int, ...],
    class_num: int,
    seed: int,
    noise: float = 0.35,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Gaussian class clusters in feature space — linearly separable enough
    to show real convergence curves, hard enough to be non-trivial."""
    rng = np.random.default_rng(seed)
    dim = int(np.prod(feature_shape))
    centers = rng.normal(0.0, 1.0, size=(class_num, dim)).astype(np.float32)

    def gen(n):
        y = rng.integers(0, class_num, size=n)
        x = centers[y] + noise * rng.normal(size=(n, dim)).astype(np.float32)
        return x.reshape((n, *feature_shape)).astype(np.float32), y.astype(np.int32)

    xtr, ytr = gen(n_train)
    xte, yte = gen(n_test)
    return xtr, ytr, xte, yte


def _partition_and_pack(
    args: Any,
    xtr: np.ndarray,
    ytr: np.ndarray,
    xte: np.ndarray,
    yte: np.ndarray,
    class_num: int,
) -> FederatedDataset:
    client_num = int(getattr(args, "client_num_in_total", 4))
    method = str(getattr(args, "partition_method", "hetero")).lower()
    alpha = float(getattr(args, "partition_alpha", 0.5))
    seed = int(getattr(args, "random_seed", 0))
    if method in ("hetero", "dirichlet", "noniid"):
        train_map = non_iid_partition_with_dirichlet_distribution(
            ytr, client_num, class_num, alpha, seed=seed
        )
    else:
        train_map = homo_partition(len(ytr), client_num, seed=seed)
    test_map = homo_partition(len(yte), client_num, seed=seed + 1)

    train_local = {i: (xtr[idx], ytr[idx]) for i, idx in train_map.items()}
    test_local = {i: (xte[idx], yte[idx]) for i, idx in test_map.items()}
    return FederatedDataset(
        train_data_num=len(ytr),
        test_data_num=len(yte),
        train_data_global=(xtr, ytr),
        test_data_global=(xte, yte),
        train_data_local_num_dict={i: len(idx) for i, idx in train_map.items()},
        train_data_local_dict=train_local,
        test_data_local_dict=test_local,
        class_num=class_num,
        feature_dim=int(np.prod(xtr.shape[1:])),
        stats=record_data_stats(ytr, train_map),
    )


# --------------------------------------------------------------------------
# datasets
# --------------------------------------------------------------------------

@register_dataset("synthetic", "synthetic_1_1")
def load_synthetic(args: Any) -> FederatedDataset:
    class_num = int(getattr(args, "class_num", 10))
    dim = int(getattr(args, "feature_dim", 60))
    n_train = int(getattr(args, "train_size", 2000))
    n_test = int(getattr(args, "test_size", 500))
    seed = int(getattr(args, "random_seed", 0))
    xtr, ytr, xte, yte = _make_classification_arrays(
        n_train, n_test, (dim,), class_num, seed
    )
    return _partition_and_pack(args, xtr, ytr, xte, yte, class_num)


@register_dataset("synthetic_image")
def load_synthetic_image(args: Any) -> FederatedDataset:
    """Class-clustered synthetic images at a configurable size — the
    CPU-friendly stand-in for CV-model tests (image_size=8 keeps conv
    stacks fast where a 28x28 input buys nothing)."""
    class_num = int(getattr(args, "class_num", 10))
    size = int(getattr(args, "image_size", 8))
    channels = int(getattr(args, "image_channels", 1))
    n_train = int(getattr(args, "train_size", 256))
    n_test = int(getattr(args, "test_size", 64))
    seed = int(getattr(args, "random_seed", 0))
    xtr, ytr, xte, yte = _make_classification_arrays(
        n_train, n_test, (size, size, channels), class_num, seed
    )
    return _partition_and_pack(args, xtr, ytr, xte, yte, class_num)


@register_dataset("mnist")
def load_mnist(args: Any) -> FederatedDataset:
    """MNIST: real ``mnist.npz`` if cached locally, else synthetic 28×28."""
    cache = str(getattr(args, "data_cache_dir", "") or "")
    path = os.path.join(cache, "mnist.npz") if cache else ""
    idx_files = [os.path.join(cache, f) for f in (
        "train-images-idx3-ubyte", "train-labels-idx1-ubyte",
        "t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")] if cache else []
    if path and os.path.exists(path):
        with np.load(path) as d:
            xtr = (d["x_train"].astype(np.float32) / 255.0).reshape(-1, 784)
            ytr = d["y_train"].astype(np.int32)
            xte = (d["x_test"].astype(np.float32) / 255.0).reshape(-1, 784)
            yte = d["y_test"].astype(np.int32)
    elif idx_files and all(os.path.exists(f) for f in idx_files):
        # the raw download format (yann.lecun.com idx files) — parsed as
        # the reference's native reader's numpy twin parses it.
        # ALL four files must be present: a partial cache (interrupted
        # download) takes the documented synthetic fallback instead of
        # crashing on the missing sibling.
        xtr, ytr = _read_mnist(idx_files[0], idx_files[1])
        xte, yte = _read_mnist(idx_files[2], idx_files[3])
    else:
        _synthetic_fallback("mnist", f"no mnist.npz under {cache!r}")
        xtr, ytr, xte, yte = _make_classification_arrays(
            int(getattr(args, "train_size", 6000)),
            int(getattr(args, "test_size", 1000)),
            (784,),
            10,
            int(getattr(args, "random_seed", 0)) + 1,
        )
    return _partition_and_pack(args, xtr, ytr, xte, yte, 10)


# -- LEAF json (femnist/shakespeare natural per-user partitions) -----------

LEAF_CHARSET = (
    "\n !\"&'(),-.0123456789:;>?ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    "[]abcdefghijklmnopqrstuvwxyz}" + "".join(chr(c) for c in range(1, 12))
)  # 90 symbols, matching the shakespeare vocab


def leaf_encode(text: str, vocab: int = 90) -> np.ndarray:
    table = {ch: i for i, ch in enumerate(LEAF_CHARSET[:vocab])}
    return np.asarray([table.get(ch, 0) for ch in text], np.int32)


def _load_leaf_json(cache: str, name: str):
    """Read LEAF's ``{name}_train.json`` / ``{name}_test.json``:
    {"users": [...], "user_data": {user: {"x": [...], "y": [...]}}}.
    Returns (train_user_data, test_user_data) or None."""
    import json as _json

    out = []
    for split in ("train", "test"):
        path = os.path.join(cache, f"{name}_{split}.json") if cache else ""
        if not path or not os.path.exists(path):
            return None
        with open(path) as f:
            payload = _json.load(f)
        out.append({u: payload["user_data"][u] for u in payload["users"]})
    return out


def _pack_leaf_users(args, train_users, test_users, to_arrays, class_num,
                     feature_dim):
    """LEAF's point is the NATURAL partition: clients = users (grouped
    round-robin onto client_num buckets when there are more users)."""
    users = sorted(train_users)
    client_num = int(getattr(args, "client_num_in_total", len(users)))
    if client_num > len(users):
        # more clients than LEAF users cannot be satisfied — an empty
        # client would crash concatenation and train on nothing anyway
        import logging

        logging.getLogger(__name__).warning(
            "LEAF partition: %d clients requested but only %d users; "
            "using %d clients", client_num, len(users), len(users))
        client_num = len(users)
    buckets = {i: [] for i in range(client_num)}
    for j, u in enumerate(users):
        buckets[j % client_num].append(u)

    def cat(users_list, table):
        xs, ys = [], []
        for u in users_list:
            x, y = to_arrays(table[u])
            xs.append(x)
            ys.append(y)
        return (np.concatenate(xs), np.concatenate(ys)) if xs else \
            (np.zeros((0, feature_dim), np.float32), np.zeros(0, np.int32))

    train_local = {i: cat(buckets[i], train_users) for i in buckets}
    test_all_users = sorted(test_users)
    xte, yte = cat(test_all_users, test_users)
    xtr = np.concatenate([train_local[i][0] for i in buckets])
    ytr = np.concatenate([train_local[i][1] for i in buckets])
    test_local = {i: (xte, yte) for i in buckets}
    return FederatedDataset(
        train_data_num=len(ytr),
        test_data_num=len(yte),
        train_data_global=(xtr, ytr),
        test_data_global=(xte, yte),
        train_data_local_num_dict={i: len(train_local[i][1]) for i in buckets},
        train_data_local_dict=train_local,
        test_data_local_dict=test_local,
        class_num=class_num,
        feature_dim=feature_dim,
        stats={"leaf_users": len(users)},
    )


# -- LEAF json (femnist/shakespeare natural per-user partitions) -----------

LEAF_CHARSET = (
    "\n !\"&'(),-.0123456789:;>?ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    "[]abcdefghijklmnopqrstuvwxyz}" + "".join(chr(c) for c in range(1, 12))
)  # 90 symbols, matching the shakespeare vocab


def leaf_encode(text: str, vocab: int = 90) -> np.ndarray:
    table = {ch: i for i, ch in enumerate(LEAF_CHARSET[:vocab])}
    return np.asarray([table.get(ch, 0) for ch in text], np.int32)


def _load_leaf_json(cache: str, name: str):
    """Read LEAF's ``{name}_train.json`` / ``{name}_test.json``:
    {"users": [...], "user_data": {user: {"x": [...], "y": [...]}}}.
    Returns (train_user_data, test_user_data) or None."""
    import json as _json

    out = []
    for split in ("train", "test"):
        path = os.path.join(cache, f"{name}_{split}.json") if cache else ""
        if not path or not os.path.exists(path):
            return None
        with open(path) as f:
            payload = _json.load(f)
        out.append({u: payload["user_data"][u] for u in payload["users"]})
    return out


def _pack_leaf_users(args, train_users, test_users, to_arrays, class_num,
                     feature_dim):
    """LEAF's point is the NATURAL partition: clients = users (grouped
    round-robin onto client_num buckets when there are more users)."""
    users = sorted(train_users)
    client_num = int(getattr(args, "client_num_in_total", len(users)))
    if client_num > len(users):
        # more clients than LEAF users cannot be satisfied — an empty
        # client would crash concatenation and train on nothing anyway
        import logging

        logging.getLogger(__name__).warning(
            "LEAF partition: %d clients requested but only %d users; "
            "using %d clients", client_num, len(users), len(users))
        client_num = len(users)
    buckets = {i: [] for i in range(client_num)}
    for j, u in enumerate(users):
        buckets[j % client_num].append(u)

    def cat(users_list, table):
        xs, ys = [], []
        for u in users_list:
            x, y = to_arrays(table[u])
            xs.append(x)
            ys.append(y)
        return (np.concatenate(xs), np.concatenate(ys)) if xs else \
            (np.zeros((0, feature_dim), np.float32), np.zeros(0, np.int32))

    train_local = {i: cat(buckets[i], train_users) for i in buckets}
    test_all_users = sorted(test_users)
    xte, yte = cat(test_all_users, test_users)
    xtr = np.concatenate([train_local[i][0] for i in buckets])
    ytr = np.concatenate([train_local[i][1] for i in buckets])
    test_local = {i: (xte, yte) for i in buckets}
    return FederatedDataset(
        train_data_num=len(ytr),
        test_data_num=len(yte),
        train_data_global=(xtr, ytr),
        test_data_global=(xte, yte),
        train_data_local_num_dict={i: len(train_local[i][1]) for i in buckets},
        train_data_local_dict=train_local,
        test_data_local_dict=test_local,
        class_num=class_num,
        feature_dim=feature_dim,
        stats={"leaf_users": len(users)},
    )


@register_dataset("cifar10", "cinic10")
def load_cifar10(args: Any) -> FederatedDataset:
    xtr, ytr, xte, yte = _load_image_or_synthetic(args, (32, 32, 3), 10, "cifar10")
    return _partition_and_pack(args, xtr, ytr, xte, yte, 10)


def _load_image_or_synthetic(args, shape, classes, name):
    cache = str(getattr(args, "data_cache_dir", "") or "")
    path = os.path.join(cache, f"{name}.npz") if cache else ""
    if path and os.path.exists(path):
        with np.load(path) as d:
            return (
                d["x_train"].astype(np.float32) / 255.0,
                d["y_train"].astype(np.int32).ravel(),
                d["x_test"].astype(np.float32) / 255.0,
                d["y_test"].astype(np.int32).ravel(),
            )
    bin1 = os.path.join(cache, "data_batch_1.bin") if cache else ""
    if name == "cifar10" and bin1 and os.path.exists(bin1):
        # the raw cifar-10-binary download layout, CHW records → HWC floats
        train_bins = [os.path.join(cache, f"data_batch_{i}.bin")
                      for i in range(1, 6)]
        xtr, ytr = _read_cifar10_batches(
            [p for p in train_bins if os.path.exists(p)])
        test_bin = os.path.join(cache, "test_batch.bin")
        if os.path.exists(test_bin):
            xte, yte = _read_cifar10_batches([test_bin])
        else:  # no test batch shipped: hold out the tail of train
            k = max(1, len(ytr) // 10)
            xte, yte = xtr[-k:], ytr[-k:]
            xtr, ytr = xtr[:-k], ytr[:-k]
        return xtr, ytr, xte, yte
    _synthetic_fallback(name, f"no {name}.npz under {cache!r}")
    return _make_classification_arrays(
        int(getattr(args, "train_size", 4000)),
        int(getattr(args, "test_size", 800)),
        shape,
        classes,
        int(getattr(args, "random_seed", 0)) + hash(name) % 1000,
    )


@register_dataset("shakespeare", "fed_shakespeare")
def load_shakespeare(args: Any) -> FederatedDataset:
    """Next-character prediction; LEAF-format json if cached, else synthetic
    character streams with n-gram structure (so an LSTM can actually learn)."""
    seq_len = int(getattr(args, "seq_len", 80))
    vocab = 90  # LEAF shakespeare charset size
    cache = str(getattr(args, "data_cache_dir", "") or "")
    # LEAF json (natural speaker partition): x = seq_len-char strings,
    # y = the next character
    leaf = _load_leaf_json(cache, "shakespeare")
    if leaf is not None:
        def to_arrays(ud):
            xs = np.stack([
                np.pad(leaf_encode(s, vocab)[:seq_len],
                       (0, max(0, seq_len - len(s))))
                for s in ud["x"]
            ])
            # next-char target broadcast over the sequence positions:
            # shifted input + final next-char (LEAF's y)
            ys = np.concatenate(
                [xs[:, 1:], np.stack([leaf_encode(c, vocab)[:1]
                                      for c in ud["y"]])], axis=1)
            return xs.astype(np.int32), ys.astype(np.int32)

        ds = _pack_leaf_users(args, leaf[0], leaf[1], to_arrays, vocab,
                              seq_len)
        return ds
    corpus = None
    if cache:
        for fname in ("shakespeare.txt", "all_data.txt"):
            p = os.path.join(cache, fname)
            if os.path.exists(p):
                with open(p, "rb") as f:
                    corpus = np.frombuffer(f.read(), dtype=np.uint8) % vocab
                break
    if corpus is None:
        _synthetic_fallback(
            str(getattr(args, "dataset", "shakespeare")),
            f"no shakespeare.txt/all_data.txt under {cache!r}")
        rng = np.random.default_rng(int(getattr(args, "random_seed", 0)) + 5)
        # order-1 markov chain over the charset → learnable structure
        trans = rng.dirichlet(np.full(vocab, 0.05), size=vocab)
        n = int(getattr(args, "train_size", 200_000))
        corpus = np.empty(n, dtype=np.int64)
        corpus[0] = 0
        # vectorized markov sampling via inverse-cdf on per-state uniforms
        cdf = np.cumsum(trans, axis=1)
        u = rng.random(n)
        for i in range(1, n):
            corpus[i] = np.searchsorted(cdf[corpus[i - 1]], u[i])
    n_seq = len(corpus) // (seq_len + 1)
    chunks = corpus[: n_seq * (seq_len + 1)].reshape(n_seq, seq_len + 1)
    x, y = chunks[:, :-1].astype(np.int32), chunks[:, 1:].astype(np.int32)
    n_test = max(1, n_seq // 10)
    xtr, ytr, xte, yte = x[:-n_test], y[:-n_test], x[-n_test:], y[-n_test:]
    # partition by contiguous ranges (clients = "speakers")
    client_num = int(getattr(args, "client_num_in_total", 4))
    train_local = {}
    if len(xtr) >= client_num:
        # near-contiguous split; linspace bounds differ by >=1 everywhere
        # when len(xtr) >= client_num, so no client is empty
        bounds = np.linspace(0, len(xtr), client_num + 1).astype(int)
        for i in range(client_num):
            sl = slice(bounds[i], bounds[i + 1])
            train_local[i] = (xtr[sl], ytr[sl])
    else:
        # tiny corpus: stride with wraparound so every client still holds
        # >=1 sequence (duplication is fine for the synthetic path)
        for i in range(client_num):
            idx = np.arange(i, i + 1) % len(xtr)
            train_local[i] = (xtr[idx], ytr[idx])
    test_local = {i: (xte, yte) for i in range(client_num)}
    return FederatedDataset(
        train_data_num=len(xtr),
        test_data_num=len(xte),
        train_data_global=(xtr, ytr),
        test_data_global=(xte, yte),
        train_data_local_num_dict={i: len(train_local[i][0]) for i in train_local},
        train_data_local_dict=train_local,
        test_data_local_dict=test_local,
        class_num=vocab,
        feature_dim=seq_len,
    )


@register_dataset("synthetic_lm", "fedllm", "databricks-dolly")
def load_synthetic_lm(args: Any) -> FederatedDataset:
    """Causal-LM token streams for the LLM path.

    An order-1 Markov token stream with a banded transition matrix (token t
    mostly moves to t+1 or t+2 mod V, 5% uniform noise): enough structure
    that per-round eval loss falls measurably. Samples are
    (x, y) = (tokens[:-1], tokens[1:]) of shape [T]; the train set is split
    into ``client_num_in_total`` contiguous shards.
    """
    seq_len = int(getattr(args, "max_seq_length", getattr(args, "seq_len", 128)))
    vocab = int(getattr(args, "vocab_size", 256))
    n_train = int(getattr(args, "train_size", 512))
    n_test = int(getattr(args, "test_size", 64))
    seed = int(getattr(args, "random_seed", 0))
    rng = np.random.default_rng(seed + 77)

    def gen(n):
        toks = np.zeros((n, seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, vocab, size=n)
        step = rng.choice([1, 2], p=[0.8, 0.2], size=(n, seq_len))
        noise = rng.random((n, seq_len)) < 0.05
        rand_tok = rng.integers(0, vocab, size=(n, seq_len))
        for t in range(seq_len):
            nxt = (toks[:, t] + step[:, t]) % vocab
            toks[:, t + 1] = np.where(noise[:, t], rand_tok[:, t], nxt)
        return toks[:, :-1], toks[:, 1:]

    xtr, ytr = gen(n_train)
    xte, yte = gen(n_test)

    client_num = int(getattr(args, "client_num_in_total", 4))
    bounds = np.linspace(0, n_train, client_num + 1).astype(int)
    train_local = {
        i: (xtr[bounds[i]: bounds[i + 1]], ytr[bounds[i]: bounds[i + 1]])
        for i in range(client_num)
    }
    test_local = {i: (xte, yte) for i in range(client_num)}
    return FederatedDataset(
        train_data_num=n_train,
        test_data_num=n_test,
        train_data_global=(xtr, ytr),
        test_data_global=(xte, yte),
        train_data_local_num_dict={i: len(train_local[i][0]) for i in train_local},
        train_data_local_dict=train_local,
        test_data_local_dict=test_local,
        class_num=vocab,
        feature_dim=seq_len,
    )
