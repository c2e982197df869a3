"""QA answer-selection data pipeline — the prepareData.lua analog.

The port's own copy of ``mpit_tpu/data/qa.py`` (numpy only; the port
imports nothing of the JAX package).  Its output is the JAX loader's bit
for bit, token ids, OOV vectors and the binary cache included: the
trainer draws its negatives and its shuffle from it, and each package
reads the other's cache.

The reference streams five TSV files (word embeddings, train, valid,
test1, test2, label->answers) in 8 KB chunks, building word<->idx maps,
random OOV embeddings, and SENTBEGIN/SENTEND padding of ``conv_width``
(reference BiCNN/prepareData.lua:36-42, :90-102, :240-283), caching the
result as torch binaries for the ``preloadBinary`` fast path
(plaunch.lua:218-229; checked-in fixtures ``binary_mapWordStr2WordIdx``
etc.).  This module reproduces that surface, shaped for a device:

- parsing produces **fixed-shape padded int32 arrays + length vectors**
  (static shapes, one compiled shape for every length) instead of
  per-example tensors;
- the binary cache is one ``.npz`` + JSON sidecar (:func:`save_binary` /
  :func:`load_binary`);
- when no corpus files exist, :func:`synthetic_qa` writes a small
  deterministic corpus in the reference's exact file formats and the
  normal parser ingests it — tests and benches stay hermetic, and the
  parser itself is exercised.

Line formats (from prepareData.lua):
  embedding   ``word\\tv1 v2 ... vD``                        (:45-69)
  train       ``labels\\t<ignored>\\tquestion\\tanswer``     (:71-124; the
              second tab field is skipped by the reference's tab arithmetic)
  valid/test  ``labels\\tquestion\\tcandidate-pool``         (:127-165)
  label2answ  ``label\\tanswer words``                       (:238-283)

Token ids are 0-based here: SENTBEGIN=0, SENTEND=1, embedding-file words
from 2 (the reference is 1-based with SENTBEGIN=1/SENTEND=2,
prepareData.lua:36-39).
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import warnings
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

SENTBEGIN = 0
SENTEND = 1
_RESERVED = ("SENTBEGIN", "SENTEND")


class QAVocab:
    """word<->idx maps + embedding rows (prepareData.lua's three maps)."""

    def __init__(self, embedding_dim: int, oov_seed: int = 0):
        self.embedding_dim = embedding_dim
        self.str2idx: Dict[str, int] = {w: i for i, w in enumerate(_RESERVED)}
        self.idx2str: List[str] = list(_RESERVED)
        # SENTBEGIN/SENTEND get zero vectors (prepareData.lua:33-39).
        self.vectors: List[np.ndarray] = [
            np.zeros(embedding_dim, np.float32) for _ in _RESERVED
        ]
        self._oov_rng = np.random.default_rng(oov_seed)

    def __len__(self) -> int:
        return len(self.idx2str)

    def add(self, word: str, vector: Optional[np.ndarray] = None) -> int:
        idx = self.str2idx.get(word)
        if idx is not None:
            return idx
        if vector is None:
            # OOV words get uniform [0,1) embeddings (prepareData.lua:94-99).
            vector = self._oov_rng.random(self.embedding_dim, np.float32)
        idx = len(self.idx2str)
        self.str2idx[word] = idx
        self.idx2str.append(word)
        self.vectors.append(np.asarray(vector, np.float32))
        return idx

    def matrix(self) -> np.ndarray:
        return np.stack(self.vectors).astype(np.float32)


def _lines(path: pathlib.Path) -> Iterator[str]:
    """Stream non-empty lines (the reference's 8 KB-chunk reader,
    prepareData.lua:32, :43-47 — Python's buffered iteration is the idiom)."""
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.rstrip("\n")
            if line:
                yield line


def load_embeddings(path: pathlib.Path, vocab: QAVocab) -> None:
    """``word\\tvec`` lines -> vocab rows (prepareData.lua:45-69)."""
    for line in _lines(path):
        word, _, vec = line.partition("\t")
        values = np.array(vec.split(), np.float32)
        if values.shape[0] != vocab.embedding_dim:
            raise ValueError(
                f"{path}: embedding for {word!r} has dim {values.shape[0]}, "
                f"expected {vocab.embedding_dim}"
            )
        vocab.add(word, values)


def encode_sentence(words: Sequence[str], vocab: QAVocab, conv_width: int) -> List[int]:
    """conv_width SENTBEGINs + word ids (OOV added on the fly) +
    (conv_width-1) SENTENDs (prepareData.lua:90-102)."""
    ids = [SENTBEGIN] * conv_width
    ids.extend(vocab.add(w) for w in words)
    ids.extend([SENTEND] * (conv_width - 1))
    return ids


def pack_sequences(seqs: List[List[int]], max_len: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Ragged id lists -> (N, L) int32 padded with SENTEND + (N,) lengths.

    The static-shape form of the reference's per-example tensors; pad ids
    never affect the model because conv frames past ``length`` are masked
    (models/layers.masked_max_pool).
    """
    lengths = np.array([len(s) for s in seqs], np.int32)
    ncols = max(int(max_len or 0), int(lengths.max(initial=1)))
    out = np.full((len(seqs), ncols), SENTEND, np.int32)
    for i, s in enumerate(seqs):
        out[i, : len(s)] = s
    return out, lengths


@dataclasses.dataclass
class TrainSet:
    """(labels, question, positive answer) triples (prepareData.lua:122)."""

    labels: List[List[int]]  # gold answer-label lists, ragged
    q_tokens: np.ndarray  # (N, Lq) int32
    q_len: np.ndarray  # (N,)
    a_tokens: np.ndarray  # (N, La) int32
    a_len: np.ndarray

    def __len__(self) -> int:
        return len(self.labels)


@dataclasses.dataclass
class EvalSet:
    """(labels, question, candidate pool) per query (prepareData.lua:163)."""

    labels: List[List[int]]
    q_tokens: np.ndarray
    q_len: np.ndarray
    pools: List[List[int]]  # candidate answer labels, ragged

    def __len__(self) -> int:
        return len(self.labels)


@dataclasses.dataclass
class QAData:
    """Everything bicnn.lua globals carry (plaunch.lua:207-216)."""

    vocab: QAVocab
    train: TrainSet
    valid: EvalSet
    test1: EvalSet
    test2: EvalSet
    # label -> answer sentence (mapLabel2AnswerIdx, prepareData.lua:279-283),
    # packed: row i of answer_tokens is the sentence for answer_labels[i].
    answer_labels: List[int]
    answer_tokens: np.ndarray  # (A, La) int32
    answer_len: np.ndarray  # (A,)
    source: str = "files"
    # SENTBEGIN/SENTEND padding width the corpus was encoded with; recorded
    # in the binary cache so a stale cache can't silently feed a model built
    # for a different cont_conv_width (the padding is baked into the tokens).
    conv_width: int = 0

    @property
    def label2row(self) -> Dict[int, int]:
        cached = getattr(self, "_label2row", None)
        if cached is None:
            cached = {lab: i for i, lab in enumerate(self.answer_labels)}
            object.__setattr__(self, "_label2row", cached)
        return cached

    @property
    def answer_space(self) -> int:
        """#mapLabel2AnswerIdx — the negative-sampling universe
        (bicnn.lua:278)."""
        return len(self.answer_labels)


def _parse_labels(field: str) -> List[int]:
    return [int(tok) for tok in field.split()]


def parse_train(path: pathlib.Path, vocab: QAVocab, conv_width: int):
    labels, qs, ans = [], [], []
    for line in _lines(path):
        parts = line.split("\t")
        if len(parts) < 4:
            raise ValueError(f"{path}: train line needs 4 tab fields: {line[:80]!r}")
        labels.append(_parse_labels(parts[0]))
        # parts[1] is skipped — the reference reads q from after the SECOND
        # tab (prepareData.lua:84-87).
        qs.append(encode_sentence(parts[2].split(), vocab, conv_width))
        ans.append(encode_sentence(parts[3].split(), vocab, conv_width))
    q_tokens, q_len = pack_sequences(qs)
    a_tokens, a_len = pack_sequences(ans)
    return TrainSet(labels, q_tokens, q_len, a_tokens, a_len)


def parse_eval(path: pathlib.Path, vocab: QAVocab, conv_width: int) -> EvalSet:
    labels, qs, pools = [], [], []
    for line in _lines(path):
        parts = line.split("\t")
        if len(parts) < 3:
            raise ValueError(f"{path}: eval line needs 3 tab fields: {line[:80]!r}")
        labels.append(_parse_labels(parts[0]))
        qs.append(encode_sentence(parts[1].split(), vocab, conv_width))
        pools.append(_parse_labels(parts[2]))
    q_tokens, q_len = pack_sequences(qs)
    return EvalSet(labels, q_tokens, q_len, pools)


def parse_label2answers(path: pathlib.Path, vocab: QAVocab, conv_width: int):
    rows, row_labels = [], []
    for line in _lines(path):
        label_field, _, answer = line.partition("\t")
        row_labels.append(int(label_field.split()[0]))  # tempL[1], :279
        rows.append(encode_sentence(answer.split(), vocab, conv_width))
    tokens, lengths = pack_sequences(rows)
    return row_labels, tokens, lengths


def load_qa_files(
    embedding_file: pathlib.Path,
    train_file: pathlib.Path,
    valid_file: pathlib.Path,
    test_file1: pathlib.Path,
    test_file2: pathlib.Path,
    label2answ_file: pathlib.Path,
    embedding_dim: int = 100,
    conv_width: int = 2,
    oov_seed: int = 0,
) -> QAData:
    """Full prepareData.lua pass in the reference's file order (embeddings
    first so corpus words resolve to pretrained rows; later files add OOV)."""
    vocab = QAVocab(embedding_dim, oov_seed=oov_seed)
    load_embeddings(pathlib.Path(embedding_file), vocab)
    train = parse_train(pathlib.Path(train_file), vocab, conv_width)
    valid = parse_eval(pathlib.Path(valid_file), vocab, conv_width)
    test1 = parse_eval(pathlib.Path(test_file1), vocab, conv_width)
    test2 = parse_eval(pathlib.Path(test_file2), vocab, conv_width)
    labels, ans_tokens, ans_len = parse_label2answers(
        pathlib.Path(label2answ_file), vocab, conv_width
    )
    return QAData(vocab, train, valid, test1, test2, labels, ans_tokens,
                  ans_len, conv_width=conv_width)


# -- binary cache (the preloadBinary path, plaunch.lua:218-229) --------------


def save_binary(data: QAData, path: pathlib.Path) -> pathlib.Path:
    """One .npz holding every array + a JSON blob for the ragged parts.

    The write is atomic (temp file + ``os.replace``) so concurrent gang
    ranks sharing one cache path read either the old complete file or the
    new one — never a torn archive."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    ragged = {
        "conv_width": data.conv_width,
        "idx2str": data.vocab.idx2str,
        "train_labels": data.train.labels,
        "valid_labels": data.valid.labels,
        "valid_pools": data.valid.pools,
        "test1_labels": data.test1.labels,
        "test1_pools": data.test1.pools,
        "test2_labels": data.test2.labels,
        "test2_pools": data.test2.pools,
        "answer_labels": data.answer_labels,
        "embedding_dim": data.vocab.embedding_dim,
    }
    tmp = path.with_name(f".{path.name}.tmp{os.getpid()}")
    try:
        with open(tmp, "wb") as f:  # file object: savez won't munge suffixes
            np.savez_compressed(
                f,
                embeddings=data.vocab.matrix(),
                train_q=data.train.q_tokens, train_ql=data.train.q_len,
                train_a=data.train.a_tokens, train_al=data.train.a_len,
                valid_q=data.valid.q_tokens, valid_ql=data.valid.q_len,
                test1_q=data.test1.q_tokens, test1_ql=data.test1.q_len,
                test2_q=data.test2.q_tokens, test2_ql=data.test2.q_len,
                answer_tokens=data.answer_tokens, answer_len=data.answer_len,
                ragged=np.frombuffer(json.dumps(ragged).encode(), np.uint8),
            )
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)
    return path


def load_binary(
    path: pathlib.Path,
    expect_conv_width: int | None = None,
    expect_embedding_dim: int | None = None,
) -> QAData:
    """Load the .npz cache; if expectations are given, reject a cache built
    under a different config (its token padding/vectors would silently
    mismatch the model — conv_width is baked into every sentence)."""
    with np.load(path, allow_pickle=False) as z:
        ragged = json.loads(bytes(z["ragged"]).decode())
        cached_cw = ragged.get("conv_width")  # None: pre-recording cache
        cached_dim = int(ragged["embedding_dim"])
        if expect_conv_width is not None and cached_cw is None:
            # Legacy cache without the recorded width: loadable, but the
            # mismatch check can't run — say so instead of failing or
            # staying silent.
            warnings.warn(
                f"binary cache {path} predates conv_width recording; cannot "
                f"verify it matches conv_width={expect_conv_width} — rebuild "
                "the cache to silence this",
                stacklevel=2,
            )
        elif (expect_conv_width is not None
                and int(cached_cw) != expect_conv_width):
            raise ValueError(
                f"binary cache {path} was built with conv_width={cached_cw}, "
                f"config wants {expect_conv_width}; delete the cache or fix "
                "binary_path"
            )
        if expect_embedding_dim is not None and cached_dim != expect_embedding_dim:
            raise ValueError(
                f"binary cache {path} was built with embedding_dim="
                f"{cached_dim}, config wants {expect_embedding_dim}"
            )
        vocab = QAVocab(cached_dim)
        mat = z["embeddings"]
        vocab.str2idx = {w: i for i, w in enumerate(ragged["idx2str"])}
        vocab.idx2str = list(ragged["idx2str"])
        vocab.vectors = [mat[i] for i in range(mat.shape[0])]
        train = TrainSet(
            ragged["train_labels"], z["train_q"], z["train_ql"],
            z["train_a"], z["train_al"],
        )
        valid = EvalSet(ragged["valid_labels"], z["valid_q"], z["valid_ql"], ragged["valid_pools"])
        test1 = EvalSet(ragged["test1_labels"], z["test1_q"], z["test1_ql"], ragged["test1_pools"])
        test2 = EvalSet(ragged["test2_labels"], z["test2_q"], z["test2_ql"], ragged["test2_pools"])
        return QAData(
            vocab, train, valid, test1, test2,
            list(ragged["answer_labels"]), z["answer_tokens"], z["answer_len"],
            source=f"binary ({path})", conv_width=int(cached_cw or 0),
        )


# -- synthetic corpus (offline fallback, written in the reference formats) ---

_TOPICS = ["ocean", "mountain", "forest", "desert", "river", "valley",
           "glacier", "volcano", "prairie", "island"]


DOCQA_EMBEDDING_DIM = 50


def docqa_paths() -> Optional[Dict[str, pathlib.Path]]:
    """The committed REAL corpus (``data/fixtures/docqa``): answer
    selection over Python-stdlib docstrings — question = dotted name +
    parameter names, answer = the docstring's first sentence, 20-way
    candidate pools (built by ``tools/make_docqa.py``, deterministic).
    Returns None when the fixture is absent (e.g. an installed package
    without the repo checkout).  Embedding files are 50-dim
    (:data:`DOCQA_EMBEDDING_DIM`)."""
    from mpit_tpu_torch.data.fixtures import fixtures_root

    paths = corpus_paths(fixtures_root() / "docqa")
    return paths if paths["train_file"].exists() else None


def corpus_paths(directory: pathlib.Path) -> Dict[str, pathlib.Path]:
    """The six corpus files of a QA directory (single source of truth for
    the filenames shared by :func:`synthetic_qa` and :func:`load_qa`)."""
    directory = pathlib.Path(directory)
    return {
        "embedding_file": directory / "embeddings.txt",
        "train_file": directory / "train.tsv",
        "valid_file": directory / "valid.tsv",
        "test_file1": directory / "test1.tsv",
        "test_file2": directory / "test2.tsv",
        "label2answ_file": directory / "label2answers.tsv",
    }


def synthetic_qa(
    directory: pathlib.Path,
    n_labels: int = 24,
    n_train: int = 240,
    n_eval: int = 40,
    pool_size: int = 6,
    embedding_dim: int = 16,
    vocab_words: int = 120,
    seed: int = 7,
) -> Dict[str, pathlib.Path]:
    """Write a learnable toy corpus in the reference's exact TSV formats.

    Each answer label owns a small word cluster; questions about a label
    draw mostly from that cluster, so GESD similarity is learnable.  The
    embedding file intentionally covers only part of the vocabulary so
    the OOV path (prepareData.lua:90-99) is exercised.
    """
    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    words = [f"w{i:03d}" for i in range(vocab_words)]
    # Per-label word clusters (overlapping tails make the task non-trivial).
    clusters = [
        rng.choice(vocab_words, size=8, replace=False) for _ in range(n_labels)
    ]

    def sentence(label: int, length: int) -> str:
        own = clusters[label]
        picks = [
            words[int(rng.choice(own))] if rng.random() < 0.8
            else words[int(rng.integers(vocab_words))]
            for _ in range(length)
        ]
        return " ".join([_TOPICS[label % len(_TOPICS)] + str(label)] + picks)

    paths = corpus_paths(directory)
    with open(paths["embedding_file"], "w") as fh:
        for w in words[: vocab_words * 3 // 4]:  # leave a quarter OOV
            vec = rng.normal(size=embedding_dim).astype(np.float32)
            fh.write(w + "\t" + " ".join(f"{v:.5f}" for v in vec) + "\n")
    with open(paths["label2answ_file"], "w") as fh:
        for lab in range(1, n_labels + 1):
            fh.write(f"{lab}\t{sentence(lab - 1, int(rng.integers(4, 9)))}\n")
    with open(paths["train_file"], "w") as fh:
        for _ in range(n_train):
            lab = int(rng.integers(1, n_labels + 1))
            q = sentence(lab - 1, int(rng.integers(3, 7)))
            a = sentence(lab - 1, int(rng.integers(4, 9)))
            fh.write(f"{lab}\tqid\t{q}\t{a}\n")

    def eval_file(path: pathlib.Path, n: int) -> None:
        with open(path, "w") as fh:
            for _ in range(n):
                lab = int(rng.integers(1, n_labels + 1))
                q = sentence(lab - 1, int(rng.integers(3, 7)))
                negatives = rng.choice(
                    [x for x in range(1, n_labels + 1) if x != lab],
                    size=pool_size - 1, replace=False,
                )
                pool = [lab] + [int(x) for x in negatives]
                rng.shuffle(pool)
                fh.write(f"{lab}\t{q}\t" + " ".join(map(str, pool)) + "\n")

    eval_file(paths["valid_file"], n_eval)
    eval_file(paths["test_file1"], n_eval)
    eval_file(paths["test_file2"], n_eval)
    return paths


def load_qa(
    embedding_dim: Optional[int] = None,
    conv_width: Optional[int] = None,
    paths: Optional[Dict[str, pathlib.Path]] = None,
    binary_path: Optional[pathlib.Path] = None,
    synthetic_dir: Optional[pathlib.Path] = None,
    oov_seed: int = 0,
    **synthetic_kwargs,
) -> QAData:
    """Resolve the best available source: binary cache > files > synthetic.

    When loading from the binary cache, explicitly-passed ``conv_width`` /
    ``embedding_dim`` are validated against the values the cache was built
    with; left as None they accept whatever the cache holds."""
    if binary_path and pathlib.Path(binary_path).exists():
        return load_binary(
            pathlib.Path(binary_path),
            expect_conv_width=conv_width,
            expect_embedding_dim=embedding_dim,
        )
    embedding_dim = 100 if embedding_dim is None else embedding_dim
    conv_width = 2 if conv_width is None else conv_width
    if paths is None:
        import tempfile

        directory = pathlib.Path(synthetic_dir or tempfile.mkdtemp(prefix="mpit_qa_"))
        paths = corpus_paths(directory)
        if not paths["train_file"].exists():
            synthetic_qa(directory, embedding_dim=embedding_dim, **synthetic_kwargs)
        data = load_qa_files(
            embedding_dim=embedding_dim, conv_width=conv_width,
            oov_seed=oov_seed, **paths,
        )
        data.source = f"synthetic ({directory})"
        return data
    data = load_qa_files(
        embedding_dim=embedding_dim, conv_width=conv_width,
        oov_seed=oov_seed, **{k: pathlib.Path(v) for k, v in paths.items()},
    )
    return data
