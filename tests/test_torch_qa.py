"""The port's QA loader (``mpit_tpu_torch.data.qa``) against the JAX
package's, on the CPU.

The BiCNN trainer draws its negatives and its shuffle from what the
loader returns, so the two must agree bit for bit: every padded token
array and length vector, the vocabulary (its order and its embedding
matrix, the OOV rows drawn from the seed included), the labels and the
candidate pools.  Both corpora the trainers read are held: the committed
docqa fixture (50-dim, conv width 2) and the synthetic corpus written in
the reference's TSV formats.  Each package also reads the other's binary
cache.  Tolerance: none, the arrays are compared for equal bytes.
"""

import dataclasses

import numpy as np
import pytest

from mpit_tpu.data import qa as jqa
from mpit_tpu_torch.data import qa as tqa


def _assert_same(a, b):
    assert a.vocab.idx2str == b.vocab.idx2str
    assert a.vocab.str2idx == b.vocab.str2idx
    ma, mb = a.vocab.matrix(), b.vocab.matrix()
    assert ma.dtype == mb.dtype == np.float32 and ma.tobytes() == mb.tobytes()
    assert a.answer_labels == b.answer_labels
    assert a.conv_width == b.conv_width
    for x, y in ((a.answer_tokens, b.answer_tokens), (a.answer_len, b.answer_len)):
        assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes()
    for name in ("train", "valid", "test1", "test2"):
        sa, sb = getattr(a, name), getattr(b, name)
        for f in dataclasses.fields(sa):
            x, y = getattr(sa, f.name), getattr(sb, f.name)
            if isinstance(x, np.ndarray):
                assert x.dtype == y.dtype and x.shape == y.shape
                assert x.tobytes() == y.tobytes(), (name, f.name)
            else:
                assert x == y, (name, f.name)


def _load(mod, source, tmp_path):
    if source == "docqa":
        return mod.load_qa(embedding_dim=mod.DOCQA_EMBEDDING_DIM, conv_width=2,
                           paths=mod.docqa_paths(), oov_seed=1)
    paths = jqa.synthetic_qa(tmp_path / "corpus", n_labels=10, n_train=96, n_eval=16,
                             embedding_dim=6, vocab_words=60, seed=11)
    return mod.load_qa_files(embedding_dim=6, conv_width=3, oov_seed=2, **paths)


@pytest.mark.parametrize("source", ["docqa", "synthetic"])
def test_load_qa_is_the_reference_bit_for_bit(source, tmp_path):
    ref = _load(jqa, source, tmp_path)
    port = _load(tqa, source, tmp_path)
    _assert_same(port, ref)
    if source == "docqa":  # the full-width configuration's shapes
        assert (len(port.vocab), len(port.train), port.answer_space) == (3041, 1021, 1459)
        assert port.answer_tokens.shape[1] == 42 and port.train.q_tokens.shape[1] == 19


def test_synthetic_corpus_files_are_the_references(tmp_path):
    kw = dict(n_labels=8, n_train=40, n_eval=10, embedding_dim=5, vocab_words=50, seed=4)
    a = jqa.synthetic_qa(tmp_path / "jax", **kw)
    b = tqa.synthetic_qa(tmp_path / "port", **kw)
    assert sorted(a) == sorted(b)
    for key in a:
        assert a[key].read_bytes() == b[key].read_bytes(), key


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_reads_the_others_cache(writer, tmp_path):
    data = _load(jqa, "synthetic", tmp_path)
    cache = tmp_path / "qa_cache.npz"
    write, read = (tqa, jqa) if writer == "port" else (jqa, tqa)
    write.save_binary(data, cache)
    back = read.load_qa(binary_path=cache, conv_width=3, embedding_dim=6)
    assert back.source.startswith("binary")
    _assert_same(back, data)
    with pytest.raises(ValueError, match="conv_width"):
        read.load_qa(binary_path=cache, conv_width=2)
