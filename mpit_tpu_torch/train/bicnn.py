"""BiCNN trainer — the port of ``mpit_tpu/train/bicnn.py`` (the bicnn.lua
workload).

The reference's whole training file (BiCNN/bicnn.lua), as the JAX package
rebuilt it: the negative-sampling feval (:305-410) with the margin ranking
loss (:121), L1/L2 regularization and the gradient clamp (:387-409), the
loss print every ``loss_report_every`` fevals (:414-418), ``test3`` over
valid/test1/test2 with the best accuracy tracked (:465-571), the
dedicated tester's pull/eval/save loop (:580-596), the shuffled train loop
with commperiod-gated ``lastClient`` testing (:598-638), and the 14-name
optimizer dispatch (:127-252) over the port's optimizers.

The feval: each example draws its ``maxnegsample`` candidate answers up
front on the host (rejecting gold labels, as the reference's inner
``while`` does, :325-330); one batched pass scores all (B, K) candidates,
picks per example the FIRST margin-violating one (the reference's early
``break``, :348-358), and takes the loss and gradient of the picked pairs.
An example with no violating candidate adds no loss and no gradient.
Gradients come from ``torch.autograd`` into the flat vector
(:meth:`mpit_tpu_torch.models.flat.FlatModel.apply_flat` with
``method=BiCNN.embed``).  The batch gradient is clamped once, and the
regularization is scaled by the number of contributing examples, as in
the JAX package.

The parameters and the optimizer state live on ``device`` (the card
unless ``device="cpu"``).  With momentum, ``sgd`` and ``eamsgd`` commit
through K1; the server-side ``adam`` rule and ``adamsingle``'s local step
run K3.  Losses are summed on the device and fetched at report time and
once an epoch.  The port's shards and parameters are float32: another
``dtype`` raises, naming the later slice.
"""

from __future__ import annotations

import pathlib
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mpit_tpu_torch.data.qa import EvalSet, QAData, load_qa
from mpit_tpu_torch.models.bicnn import BiCNN, gesd, margin_ranking_loss
from mpit_tpu_torch.models.flat import flatten_module
from mpit_tpu_torch.obs.timers import PhaseTimers
from mpit_tpu_torch.optim import EAMSGD, MSGD, Downpour, RuleShell, SingleWorker
from mpit_tpu_torch.optim import rules as rules_mod
from mpit_tpu_torch.optim.msgd import MSGDConfig
from mpit_tpu_torch.utils.checkpoint import load_flat, save_flat
from mpit_tpu_torch.utils.config import Config
from mpit_tpu_torch.utils.logging import get_logger
from mpit_tpu_torch.utils.platform import resolve_device

QA_FILE_KEYS = ("embedding_file", "train_file", "valid_file",
                "test_file1", "test_file2", "label2answ_file")

#: What a non-float32 ``dtype`` belongs to.
DTYPE_SLICE = "BiCNN at other dtypes (a later slice of the port; its shards are float32)"


def explicit_qa_files(cfg) -> bool:
    """True when all six corpus files are given explicitly: then the file
    flags win over the docqa fixture (the trainer's ``_load_data`` and the
    launcher's parent-side check agree on this one predicate)."""
    return all(cfg.get(k, "none") != "none" for k in QA_FILE_KEYS)


# The plaunch.lua flag surface (reference BiCNN/plaunch.lua:7-69),
# snake_cased, the JAX package's knobs, and the port's ``device``.
BICNN_DEFAULTS = Config(
    optimization="downpour",  # sgd|downpour|eamsgd|easgd|adam|adamax|adamsingle|
    #   adamaxsingle|rmsprop|rmspropsingle|adagrad|adagradsingle|adadelta|
    #   adadeltasingle (plaunch.lua:11)
    learning_rate=1e-2,
    batch_size=1,  # plaunch.lua:13 (1 = pure stochastic)
    lr_adagrad=1e-3,
    lr_decay_adagrad=1e-6,
    epsilon_adagrad=1e-10,
    rho_adadelta=0.9,
    lr_adadelta=1.0,
    epsilon_adadelta=1e-6,
    lr_adam=1e-3,
    beta1_adam=0.9,
    beta2_adam=0.999,
    epsilon_adam=1e-8,
    step_div_adam=72,
    grad_clip=0.5,
    weight_decay=1e-6,
    decay_rmsprop=0.95,
    lr_rmsprop=1e-4,
    momentum_rmsprop=0.9,
    epsilon_rmsprop=1e-4,
    momentum=0.0,
    commperiod=1,
    movingrate=0.05,
    dtype="float32",  # the 'type' flag; other dtypes are a later slice
    train_file="none",
    valid_file="none",
    test_file1="none",
    test_file2="none",
    label2answ_file="none",
    embedding_file="none",
    embedding_dim=100,
    cont_conv_width=2,
    word_hidden_dim=200,
    num_filters=3000,
    epoch=50,
    l1reg=0.0,
    l2reg=1e-4,
    margin=0.02,
    maxnegsample=100,
    valid_mode="additionalTester",  # none | lastClient | additionalTester
    valid_sleep_time=1.0,
    mmode=1,  # 1|2 — graph-plumbing variants of the same math
    outputprefix="none",
    prevtime=0.0,
    loadmodel="none",
    preload_binary=False,
    binary_path="",  # where the preload_binary cache lives (.npz)
    testerfirst=False,
    testerlast=False,
    master_freq=2,
    maxrank=120,
    singlemode=False,
    docqa=False,  # train on the committed stdlib-docstring corpus
    seed=1,
    loss_report_every=2000,  # bicnn.lua:414 prints every 2000 fevals
    tester_rounds=10,  # the tester's bounded lifecycle
    eval_chunk=64,  # batch size for answer/query embedding at eval
    device="cuda",  # cuda | cpu: where parameters and optimizer state live
)

_SINGLE = {
    "adamsingle": "adam", "adamaxsingle": "adamax", "rmspropsingle": "rmsprop",
    "adagradsingle": "adagrad", "adadeltasingle": "adadelta",
}
_GLOBAL = ("adam", "adamax", "rmsprop", "adagrad", "adadelta")


def rule_hyperparams(cfg: Config, rule: str) -> Dict[str, Any]:
    """Per-method hyperparameters from the plaunch flag groups (reference
    plaunch.lua:15-36 -> pserver dispatch BiCNN/pserver.lua:123-197)."""
    if rule in ("adam", "adamax"):
        return dict(lr=cfg.lr_adam, beta1=cfg.beta1_adam,
                    beta2=cfg.beta2_adam, epsilon=cfg.epsilon_adam)
    if rule == "rmsprop":
        return dict(lr=cfg.lr_rmsprop, decay=cfg.decay_rmsprop,
                    momentum=cfg.momentum_rmsprop, epsilon=cfg.epsilon_rmsprop)
    if rule == "adagrad":
        return dict(lr=cfg.lr_adagrad, lrd=cfg.lr_decay_adagrad,
                    epsilon=cfg.epsilon_adagrad)
    if rule == "adadelta":
        return dict(lr=cfg.lr_adadelta, rho=cfg.rho_adadelta,
                    epsilon=cfg.epsilon_adadelta)
    raise ValueError(f"no hyperparameter group for rule {rule!r}")


def server_rule_for(cfg: Config) -> rules_mod.ShardRule:
    """The server's shard rule for the client optimizer (reference
    BiCNN/pserver.lua:123-197): the stateful rules for the global shells,
    Adam's bias correction stepDiv-scaled (:140-155); ``add`` otherwise."""
    name = cfg.optimization
    if name in _GLOBAL:
        hp = rule_hyperparams(cfg, name)
        if name == "adam":
            hp["step_div"] = cfg.step_div_adam
        return rules_mod.make(name, **hp)
    return rules_mod.make("add")


def gesd_np(q: np.ndarray, a: np.ndarray) -> np.ndarray:
    """Host GESD over (F,) x (P, F) — the eval-time inlined formula
    (reference bicnn.lua:440-443), the oracle of :func:`_pool_score`."""
    dot = a @ q
    l2 = np.sqrt(np.maximum(((a - q) ** 2).sum(axis=-1), 0.0))
    return 1.0 / ((1.0 + l2) * (1.0 + np.exp(-(dot + 1.0))))


@torch.no_grad()
def _pool_score(q_emb: torch.Tensor, ans_emb: torch.Tensor, idx: torch.Tensor,
                mask: torch.Tensor, hit: torch.Tensor, chunk: int = 32) -> torch.Tensor:
    """Questions answered right, as a 0-d tensor on the device: each
    question's candidate pool (``idx`` rows of the answer matrix; ``mask``
    the slots known to the answer space, bicnn.lua:434; ``hit`` the gold
    slots) scored with the direct GESD form of :func:`gesd_np` (an expanded
    ``|q|^2+|a|^2-2qa`` form would cancel for the near-ties that decide the
    choice), ``chunk`` questions at a time to bound memory at
    O(chunk * P * F).  Ties keep the LAST maximum (bicnn.lua:444-447),
    through argmax of the reversed pool axis; masked slots score -inf."""
    qf, af = q_emb.float(), ans_emb.float()
    p = idx.shape[1]
    correct = torch.zeros((), dtype=torch.int64, device=qf.device)
    for lo in range(0, idx.shape[0], chunk):
        qc, ic, mc, hc = (t[lo:lo + chunk] for t in (qf, idx, mask, hit))
        ac = af[ic]  # (C, P, F)
        dot = torch.einsum("cpf,cf->cp", ac, qc)
        l2 = torch.sqrt(torch.clamp(((ac - qc[:, None, :]) ** 2).sum(dim=-1), min=0.0))
        sims = 1.0 / ((1.0 + l2) * (1.0 + torch.exp(-(dot + 1.0))))
        sims = torch.where(mc, sims, torch.full((), -torch.inf, device=sims.device))
        best = p - 1 - torch.argmax(sims.flip(1), dim=1)  # the LAST max
        chosen = torch.take_along_dim(hc, best[:, None], dim=1)[:, 0]
        correct += (chosen & mc.any(dim=1)).sum()
    return correct


class BiCNNTrainer:
    """The bicnn.lua workload: the train or the tester role."""

    KNOWN_OPTS = ("sgd", "downpour", "eamsgd", "easgd") + _GLOBAL + tuple(_SINGLE)

    def __init__(
        self,
        cfg: Optional[Config] = None,
        pclient: Any = None,
        data: Optional[QAData] = None,
        rank: int = 0,
    ):
        self.cfg = cfg = BICNN_DEFAULTS.merged(cfg.to_dict() if cfg else None)
        if cfg.dtype != "float32":
            raise NotImplementedError(f"dtype={cfg.dtype!r}: {DTYPE_SLICE}")
        self.pc = pclient
        self.rank = rank
        self.device = resolve_device(cfg.device)
        self.log = get_logger("bicnn", rank)
        self.tm = PhaseTimers()
        self.rng = np.random.default_rng(cfg.seed + rank)

        if data is None:
            data = self._load_data()
        self.data = data
        self.log.info(
            "data: %s (%d train, %d answers, vocab %d)",
            data.source, len(data.train), data.answer_space, len(data.vocab),
        )
        module = BiCNN(
            vocab_size=len(data.vocab),
            # The data's embedding width is authoritative (the 50-dim docqa
            # fixture wins over the config default).
            embedding_dim=data.vocab.embedding_dim,
            word_hidden_dim=cfg.word_hidden_dim,
            num_filters=cfg.num_filters,
            conv_width=cfg.cont_conv_width,
        )
        self.flat = flatten_module(module, cfg.seed, self.device)
        # Pretrained vectors initialize the lookup table (bicnn.lua:34).
        self.flat.set_leaf(self.flat.w0, "tower.lookup.embedding", data.vocab.matrix())
        self.w = self.flat.w0.clone()
        if cfg.loadmodel != "none":
            w, meta = load_flat(cfg.loadmodel)
            self.w = torch.as_tensor(w, dtype=torch.float32).to(self.device)  # bicnn.lua:259-261
            self.log.info("resumed from %s (meta %s)", cfg.loadmodel, meta)

        self._pool_cache: Dict[str, tuple] = {}
        self._vgf = self._build_vgf()
        self._optimizer = None
        # The loss print's running sum stays on the device and is fetched
        # only at report time (bicnn.lua:283, :414-418).
        self._loss_acc: Any = None
        self._loss_count = 0
        self.best: Dict[str, tuple] = {}  # per-dataset best (accuracy, epoch)
        self.epoch = 0

    # -- data ----------------------------------------------------------------

    def _load_data(self) -> QAData:
        cfg = self.cfg
        explicit_files = explicit_qa_files(cfg)
        # The effective embedding width, resolved once so every branch
        # agrees: docqa's 50-dim files override an untouched default, but
        # only when the docqa branch loads the data.
        want_dim = cfg.embedding_dim
        if (cfg.get("docqa", False) and not explicit_files
                and cfg.embedding_dim == BICNN_DEFAULTS.embedding_dim):
            from mpit_tpu_torch.data.qa import DOCQA_EMBEDDING_DIM

            want_dim = DOCQA_EMBEDDING_DIM
        cache = pathlib.Path(cfg.binary_path) if (
            cfg.preload_binary and cfg.binary_path) else None
        if cache is not None and cache.exists():
            return load_qa(binary_path=cache, conv_width=cfg.cont_conv_width,
                           embedding_dim=want_dim)
        if explicit_files:
            data = load_qa(
                embedding_dim=cfg.embedding_dim, conv_width=cfg.cont_conv_width,
                paths={k: pathlib.Path(cfg.get(k)) for k in QA_FILE_KEYS},
                oov_seed=cfg.seed,
            )
        elif cfg.get("docqa", False):
            from mpit_tpu_torch.data.qa import docqa_paths

            paths = docqa_paths()
            if paths is None:
                raise FileNotFoundError(
                    "docqa=1 but data/fixtures/docqa is absent — use explicit "
                    "--*_file flags")
            data = load_qa(embedding_dim=want_dim, conv_width=cfg.cont_conv_width,
                           paths=paths, oov_seed=cfg.seed)
            data.source = "docqa fixture (real stdlib-docstring corpus)"
        else:
            data = load_qa(embedding_dim=cfg.embedding_dim,
                           conv_width=cfg.cont_conv_width, oov_seed=cfg.seed)
        if cache is not None:
            # The first run with preload_binary writes the cache
            # (plaunch.lua:218-229).
            from mpit_tpu_torch.data.qa import save_binary

            save_binary(data, cache)
            self.log.info("wrote binary cache %s (from %s)", cache, data.source)
        return data

    # -- feval ---------------------------------------------------------------

    def _build_vgf(self):
        cfg = self.cfg
        margin = float(cfg.margin)
        l1, l2 = float(cfg.l1reg), float(cfg.l2reg)
        clip = float(cfg.grad_clip)
        apply_flat = self.flat.apply_flat

        def loss_fn(w, q, ql, ap, apl, nt, nl):
            b, k, la = nt.shape
            # One tower pass per distinct input: the weights are tied.
            eq = apply_flat(w, q, ql, method=BiCNN.embed)  # (B, F)
            ep = apply_flat(w, ap, apl, method=BiCNN.embed)  # (B, F)
            en = apply_flat(w, nt.reshape(b * k, la), nl.reshape(b * k),
                            method=BiCNN.embed).reshape(b, k, -1)  # (B, K, F)
            s_pos = gesd(eq, ep)  # (B,)
            en_scores = gesd(eq[:, None, :], en)  # (B, K)
            # The first margin-violating candidate of each example
            # (bicnn.lua:348-358); argmax takes no bool, and returns the
            # first maximum.
            viol = (s_pos[:, None] - en_scores) < margin
            has = viol.any(dim=1)
            first = torch.argmax(viol.to(torch.uint8), dim=1)
            s_neg = (F.one_hot(first, k).to(en_scores.dtype) * en_scores).sum(dim=1)
            per_ex = margin_ranking_loss(s_pos, s_neg, margin) * has
            n_contrib = has.to(w.dtype).sum()
            f = per_ex.sum()
            # Per-contributing-example regularization (bicnn.lua:387-397).
            if l1:
                # |w| with slope +1 at 0, as JAX's abs has (torch.abs: 0).
                f = f + n_contrib * l1 * torch.where(w >= 0, w, -w).sum()
            if l2:
                f = f + n_contrib * l2 * 0.5 * (w * w).sum()
            return f

        def vgf(w, *args):
            with torch.enable_grad():
                leaf = w.detach().requires_grad_(True)
                loss = loss_fn(leaf, *args)
                (g,) = torch.autograd.grad(loss, leaf)
            return loss.detach(), g.clamp_(-clip, clip)  # bicnn.lua:398-409

        return vgf

    def sample_negatives(self, batch_labels: List[List[int]]) -> Tuple[np.ndarray, np.ndarray]:
        """Draw (B, K) candidate answer rows, rejecting gold labels — the
        host half of the rejection loop (bicnn.lua:325-330)."""
        data, k = self.data, int(self.cfg.maxnegsample)
        a = data.answer_space
        rows = self.rng.integers(0, a, size=(len(batch_labels), k))
        l2r = data.label2row
        for i, gold in enumerate(batch_labels):
            gold_rows = {l2r[g] for g in gold if g in l2r}
            if not gold_rows or len(gold_rows) >= a:
                continue
            bad = np.isin(rows[i], list(gold_rows))
            while bad.any():
                rows[i, bad] = self.rng.integers(0, a, size=int(bad.sum()))
                bad = np.isin(rows[i], list(gold_rows))
        nt = data.answer_tokens[rows]  # (B, K, La)
        nl = data.answer_len[rows]  # (B, K)
        return nt.astype(np.int32), nl.astype(np.int32)

    # -- optimizer dispatch (bicnn.lua:127-252, plaunch names) ---------------

    @property
    def optimizer(self):
        if self._optimizer is None:
            self._optimizer = self._make_optimizer()
        return self._optimizer

    def _make_optimizer(self):
        cfg = self.cfg
        name = cfg.optimization
        if name not in self.KNOWN_OPTS:
            raise ValueError(f"unknown optimization {name!r}; have {self.KNOWN_OPTS}")
        if name == "sgd":
            return MSGD(MSGDConfig(lr=cfg.learning_rate, mom=cfg.momentum,
                                   l2wd=cfg.weight_decay), self._vgf)
        if self.pc is None:
            raise ValueError(f"optimization {name!r} needs a parameter client")
        if name == "downpour":
            return Downpour(self._vgf, self.pc, lr=cfg.learning_rate, su=cfg.commperiod)
        if name in ("eamsgd", "easgd"):
            mom = 0.0 if name == "easgd" else cfg.momentum
            return EAMSGD(self._vgf, self.pc, lr=cfg.learning_rate, mom=mom,
                          mva=cfg.movingrate, su=cfg.commperiod)
        if name in _GLOBAL:
            # Accumulate and ship; the server applies the stateful rule.
            return RuleShell(self._vgf, self.pc, su=cfg.commperiod, mode="global")
        rule = _SINGLE[name]
        return SingleWorker(self._vgf, self.pc, rule=rule, **rule_hyperparams(cfg, rule))

    # -- evaluation (test3, bicnn.lua:465-571) -------------------------------

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    @torch.no_grad()
    def _embed_chunked(self, w, tokens: np.ndarray, lengths: np.ndarray) -> torch.Tensor:
        """Embed (N, L) in chunks of ``eval_chunk`` rows (one shape; the
        last chunk padded with the first row); stays on the device."""
        chunk = int(self.cfg.eval_chunk)
        n = tokens.shape[0]
        pad = (-n) % chunk
        if pad:
            tokens = np.concatenate([tokens, np.repeat(tokens[:1], pad, 0)])
            lengths = np.concatenate([lengths, np.repeat(lengths[:1], pad)])
        tok_d, len_d = self._to_device(tokens), self._to_device(lengths)
        outs = [self.flat.apply_flat(w, tok_d[i:i + chunk], len_d[i:i + chunk],
                                     method=BiCNN.embed)
                for i in range(0, tokens.shape[0], chunk)]
        return torch.cat(outs)[:n]

    def _pool_tables(self, eval_set: EvalSet, name: str):
        """The padded pool tables of one eval set on the device, built once:
        ``idx`` (N, P) answer rows, ``mask`` the slots known to the answer
        space (bicnn.lua:434), ``hit`` the gold slots."""
        cached = self._pool_cache.get(name)
        if cached is not None and cached[0] is eval_set:
            return cached[1:]
        l2r = self.data.label2row
        n = len(eval_set)
        p = max((len(pool) for pool in eval_set.pools), default=1) or 1
        idx = np.zeros((n, p), np.int64)
        mask = np.zeros((n, p), bool)
        hit = np.zeros((n, p), bool)
        for i, pool in enumerate(eval_set.pools):
            gold = set(eval_set.labels[i])
            for j, v in enumerate(pool):
                row = l2r.get(v)
                if row is None:
                    continue
                idx[i, j] = row
                mask[i, j] = True
                hit[i, j] = v in gold
        tables = tuple(self._to_device(t) for t in (idx, mask, hit))
        self._pool_cache[name] = (eval_set,) + tables
        return tables

    def evaluate(self, eval_set: EvalSet, name: str, w=None,
                 ans_emb: Optional[torch.Tensor] = None) -> float:
        """Pool-restricted answer-selection accuracy on one dataset — one
        leg of test3 (bicnn.lua:465-510)."""
        w = self.w if w is None else w
        data = self.data
        with self.tm.phase("test"):
            if ans_emb is None:
                ans_emb = self._embed_chunked(w, data.answer_tokens, data.answer_len)
            q_emb = self._embed_chunked(w, eval_set.q_tokens, eval_set.q_len)
            idx, mask, hit = self._pool_tables(eval_set, name)
            correct = int(_pool_score(q_emb, ans_emb, idx, mask, hit))
            acc = correct / max(len(eval_set), 1)
        prev = self.best.get(name, (0.0, -1))
        if acc > prev[0]:
            self.best[name] = (acc, self.epoch)
        best_acc = self.best.get(name, (acc, self.epoch))[0]
        self.log.info(
            "curr time: %.2f, Accuracy: %.4f, best Accuracy: %.4f on %s",
            self.tm.elapsed() + float(self.cfg.prevtime), acc, best_acc, name,
        )
        return acc

    def test3(self, w=None) -> Dict[str, float]:
        """valid + test1 + test2 (bicnn.lua:465-571, :589), the answer space
        embedded once for all three."""
        w_eval = self.w if w is None else w
        with self.tm.phase("test"):
            ans_emb = self._embed_chunked(w_eval, self.data.answer_tokens,
                                          self.data.answer_len)
        return {
            "valid": self.evaluate(self.data.valid, "valid", w_eval, ans_emb),
            "test1": self.evaluate(self.data.test1, "test1", w_eval, ans_emb),
            "test2": self.evaluate(self.data.test2, "test2", w_eval, ans_emb),
        }

    def _save_checkpoint(self) -> None:
        """Runtime-stamped whole-param save (bicnn.lua:590-594)."""
        prefix = self.cfg.outputprefix
        if prefix == "none" or not prefix:
            return
        path = pathlib.Path(prefix)
        runtime = self.tm.elapsed() + float(self.cfg.prevtime)
        save_flat(
            path.parent if path.parent != pathlib.Path("") else pathlib.Path("."),
            self.w,
            {"runtime": runtime, "epoch": self.epoch, "best": dict(self.best)},
            prefix=path.name,
        )

    # -- the train loop (bicnn.lua:598-638) ----------------------------------

    def _batches(self, order: np.ndarray):
        """Static-shape batches: the trailing partial batch wraps around
        the shuffled order (bicnn.lua:612-623 has a variable last batch)."""
        b = int(self.cfg.batch_size)
        n = len(order)
        for lo in range(0, n, b):
            idx = order[lo: lo + b]
            if len(idx) < b:
                idx = np.concatenate([idx, order[: b - len(idx)]])
            yield idx

    def step(self, idx: np.ndarray) -> torch.Tensor:
        """One feval + optimizer step on the batch rows ``idx``; returns the
        loss on the device, fetched only at report time."""
        tr = self.data.train
        labels = [tr.labels[i] for i in idx]
        with self.tm.phase("sample"):
            nt, nl = self.sample_negatives(labels)
        args = tuple(self._to_device(a) for a in (
            tr.q_tokens[idx], tr.q_len[idx], tr.a_tokens[idx], tr.a_len[idx], nt, nl))
        with self.tm.phase("feval"):
            self.w, loss = self.optimizer.step(self.w, *args)
        self._loss_acc = loss if self._loss_acc is None else self._loss_acc + loss
        self._loss_count += 1
        if self._loss_count % int(self.cfg.loss_report_every) == 0:
            self.log.info(
                "curr time: %.2f, training loss avg. : %.5f",
                self.tm.elapsed() + float(self.cfg.prevtime),
                float(self._loss_acc) / self._loss_count,
            )
            self._loss_acc, self._loss_count = None, 0
        return loss

    def run(self, is_last_client: bool = False) -> Dict[str, Any]:
        """Train for ``epoch`` epochs (the non-tester branch,
        bicnn.lua:598-638); returns the history, the final accuracies, the
        best ones, the elapsed seconds, the phase timers and the steps."""
        cfg = self.cfg
        opt = self.optimizer
        if hasattr(opt, "start"):
            with self.tm.phase("start"):
                self.w = opt.start(self.w)
        n = len(self.data.train)
        pversion = 0
        history = []
        for epoch in range(int(cfg.epoch)):
            self.epoch = epoch
            t_epoch = time.monotonic()
            order = self.rng.permutation(n)  # bicnn.lua:609
            loss_sum, steps = None, 0
            for idx in self._batches(order):
                loss = self.step(idx)
                loss_sum = loss if loss_sum is None else loss_sum + loss
                steps += 1
                # lastClient tests in training every commperiod steps
                # (bicnn.lua:625-633).
                if (cfg.valid_mode == "lastClient" and is_last_client
                        and pversion % int(cfg.commperiod) == 0):
                    self.test3()
                    self._save_checkpoint()
                pversion += 1
            avg_loss = float(loss_sum) / steps if steps else 0.0  # fences the epoch
            history.append({"epoch": epoch, "avg_loss": avg_loss,
                            "seconds": time.monotonic() - t_epoch})
            self.log.info("epoch %d done, for %.2f seconds", epoch, history[-1]["seconds"])
        accs = self.test3()
        self.tm.add("sync", getattr(opt, "dusync", 0.0))
        if hasattr(opt, "stop"):
            with self.tm.phase("stop"):
                opt.stop()
        return {
            "history": history,
            "accuracy": accs,
            "best": {k: {"acc": v[0], "epoch": v[1]} for k, v in self.best.items()},
            "elapsed": self.tm.elapsed(),
            "timers": dict(self.tm.total),
            "steps": pversion,
        }

    # -- tester role (additionalTester, bicnn.lua:580-596) -------------------

    def run_tester(self) -> Dict[str, Any]:
        """Pull params -> test3 -> checkpoint -> sleep, for ``tester_rounds``
        rounds (the reference loops forever, bicnn.lua:581)."""
        cfg = self.cfg
        if self.pc is None:
            raise ValueError("tester role needs a parameter client")
        # The tester's freshly built parameters back the client buffers:
        # with testerfirst the tester is cranks[0] and seeds the servers
        # (reference bicnn.lua:268-271, pclient.lua:125-128).
        param = self.w.detach().cpu().numpy().copy()
        grad = np.zeros_like(param)
        self.pc.start(param, grad)
        rounds = int(cfg.tester_rounds)
        history = []
        for r in range(rounds):
            self.epoch = r
            t0 = time.monotonic()
            self.pc.async_recv_param()
            self.pc.wait()
            self.log.info("communication time: %.2f", time.monotonic() - t0)
            self.w = torch.from_numpy(param).to(self.device, copy=True)
            accs = self.test3()
            history.append({"round": r, **accs})
            self._save_checkpoint()
            if r != rounds - 1:
                time.sleep(float(cfg.valid_sleep_time))
        self.pc.stop()
        return {
            "history": history,
            "best": {k: {"acc": v[0], "epoch": v[1]} for k, v in self.best.items()},
        }
