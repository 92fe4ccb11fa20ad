"""The plain reference DLRM (Naumov et al., arXiv:1906.00091; the bags of
UpDLRM's Table 1), in plain PyTorch. It imports nothing of the program.

It makes its weights from the seed (``make_weights``, which the ``dlrm``
adapter hands the program too) and works on the logical table (one row per
id of the union vocabulary, the fields' rows in order) and on the
generator's batches:

- bag sums in entry order: for each position l of a (B, F, L) bag, the row
  of each valid id (id >= 0) is added to the running sum, in fp32;
- one-hot fields: a gather of the row, cast to the dense type;
- the interaction: z = [x | emb] (B, F + 1, D), the dots z_i . z_j for
  i < j in row-major order, then x appended;
- MLPs ``x @ w + b``, ReLU between layers, none after the last;
- the loss: mean binary cross-entropy on the logits;
- the train step: gradients by autograd down to the bag sums, the table's
  gradient added row by row from the bag sums' cotangent, the MLP
  gradients clipped to a global norm, Adam on the MLPs and row-wise
  Adagrad on the table.

``precision='tf32'`` is the control: every product of the MLPs and the
interaction in TF32 (on the card the backend's TF32 switch; on the CPU,
which has no TF32, each operand rounded to TF32's 10-bit mantissa first).
"""
from __future__ import annotations

import contextlib
import math

import torch

from portbench.generate import WEIGHTS, generator

BLOCK_ROWS = 8192          # bag rows (samples) a block of the bag sums


def make_weights(cfg: dict, seed: int, device) -> dict:
    """The model's weights from the seed, in the types they are served in:
    the logical table (sum of the vocabularies, D) N(0, 0.02^2) in
    ``emb_dtype``; each MLP's (in, out) weights a standard normal cut at
    +-2 times 1/sqrt(in), its biases N(0, 0.05^2), in ``dtype``. The same
    seed gives the same bits on the same device."""
    g = generator(seed, WEIGHTS, device)
    emb_dtype = getattr(torch, cfg["emb_dtype"])
    dtype = getattr(torch, cfg["dtype"])
    V, D = sum(cfg["vocab_sizes"]), cfg["embed_dim"]
    table = (torch.randn((V, D), generator=g, device=device) * 0.02
             ).to(emb_dtype)
    F = len(cfg["vocab_sizes"])

    def mlp(dims):
        ws, bs = [], []
        for a, b in zip(dims[:-1], dims[1:]):
            w = torch.empty((a, b), device=device)
            torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=g)
            ws.append((w / math.sqrt(a)).to(dtype))
            bs.append((torch.randn((b,), generator=g, device=device) * 0.05
                       ).to(dtype))
        return {"w": ws, "b": bs}

    bot = mlp([cfg["n_dense"], *cfg["bot_mlp"]])
    top = mlp([(F + 1) * F // 2 + D, *cfg["top_mlp"], 1])
    return {"table": table, "bot": bot, "top": top}


@contextlib.contextmanager
def precision_ctx(precision: str, device):
    if precision not in ("fp32", "tf32"):
        raise ValueError(precision)
    dev = torch.device(device)
    if dev.type != "cuda":
        yield
        return
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = precision == "tf32"
    torch.backends.cudnn.allow_tf32 = precision == "tf32"
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to nearest on TF32's 10-bit mantissa (the gradient
    passes straight through)."""
    d = x.detach().contiguous()
    r = ((d.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (r - d)


def _mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "tf32" and a.device.type != "cuda":
        a, b = _tf32_round(a), _tf32_round(b)
    return a @ b


def field_offsets(cfg: dict, device) -> torch.Tensor:
    v = torch.tensor([0, *cfg["vocab_sizes"][:-1]], dtype=torch.int64,
                     device=device)
    return torch.cumsum(v, 0)


def lookup(cfg: dict, table: torch.Tensor, sparse: torch.Tensor
           ) -> torch.Tensor:
    """(B, F, D) in the dense type: bag sums in entry order (multi-hot) or
    the rows (one-hot)."""
    dtype = getattr(torch, cfg["dtype"])
    offs = field_offsets(cfg, sparse.device)
    if sparse.dim() == 2:
        rows = sparse.long() + offs[None, :]
        return table[rows].to(dtype)
    B, F, L = sparse.shape
    out = torch.zeros((B, F, table.shape[1]), dtype=torch.float32,
                      device=sparse.device)
    for s in range(0, B, BLOCK_ROWS):
        ids = sparse[s:s + BLOCK_ROWS].long()
        acc = out[s:s + BLOCK_ROWS]
        for pos in range(L):
            i = ids[:, :, pos]
            valid = i >= 0
            rows = torch.where(valid, i + offs[None, :], 0)
            acc += torch.where(valid[..., None], table[rows].float(), 0.0)
    return out.to(dtype)


def mlp(p: dict, x: torch.Tensor, precision: str) -> torch.Tensor:
    n = len(p["w"])
    for i, (w, b) in enumerate(zip(p["w"], p["b"])):
        x = _mm(x, w, precision) + b
        if i < n - 1:
            x = torch.relu(x)
    return x


def interaction(x: torch.Tensor, emb: torch.Tensor, precision: str
                ) -> torch.Tensor:
    """[dots of z = [x | emb], i < j in row-major order | x]."""
    z = torch.cat([x[:, None], emb], dim=1)
    F = z.shape[1]
    zz = _mm(z, z.transpose(1, 2), precision)
    iu, ju = torch.triu_indices(F, F, offset=1, device=z.device)
    return torch.cat([zz[:, iu, ju], x], dim=1)


def head(w: dict, dense: torch.Tensor, emb: torch.Tensor, precision: str
         ) -> torch.Tensor:
    """Logits (B,) from the dense features and the looked-up rows."""
    x = mlp(w["bot"], dense, precision)
    return mlp(w["top"], interaction(x, emb, precision), precision)[:, 0]


def scores(cfg: dict, w: dict, batch: dict, precision: str = "fp32",
           block: int = 65536) -> torch.Tensor:
    """sigmoid of the logits, (B,) fp32, in blocks of ``block`` samples."""
    out = []
    with torch.no_grad(), precision_ctx(precision, batch["dense"].device):
        for s in range(0, batch["dense"].shape[0], block):
            sp = batch["sparse"][s:s + block]
            emb = lookup(cfg, w["table"], sp)
            out.append(torch.sigmoid(head(w, batch["dense"][s:s + block],
                                          emb, precision)).float())
    return torch.cat(out)


def bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logits = logits.float()
    return torch.mean(torch.clamp(logits, min=0) - logits * labels
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def mlp_leaves(w: dict) -> list[tuple[str, torch.Tensor]]:
    """The MLP leaves by name, in a fixed order."""
    return [(f"{m}.{k}{i}", t) for m in ("bot", "top") for k in ("b", "w")
            for i, t in enumerate(w[m][k])]


def leaves(w: dict) -> list[tuple[str, torch.Tensor]]:
    """Every leaf by name: the table, then the MLP leaves."""
    return [("table", w["table"]), *mlp_leaves(w)]


def table_grad(cfg: dict, sparse: torch.Tensor, demb: torch.Tensor,
               n_rows: int) -> torch.Tensor:
    """d table (V, D) fp32 of the bag sums (or gathers) for their
    cotangent ``demb`` (B, F, D): each valid entry adds its bag's row."""
    offs = field_offsets(cfg, sparse.device)
    g = torch.zeros((n_rows, demb.shape[2]), dtype=torch.float32,
                    device=sparse.device)
    d = demb.float()
    sp = sparse if sparse.dim() == 3 else sparse[..., None]
    for pos in range(sp.shape[2]):
        i = sp[:, :, pos].long()
        valid = i >= 0
        rows = (i + offs[None, :])[valid]
        g.index_add_(0, rows, d[valid])
    return g


class Trainer:
    """The reference train step on the logical table: ``step(batch)``
    returns the loss and leaves the weights, the optimizer state and this
    step's gradients (as the optimizer got them) in ``self``."""

    def __init__(self, cfg: dict, w: dict, precision: str = "fp32"):
        self.cfg, self.w, self.precision = cfg, w, precision
        o = cfg["optimizer"]
        self.clip = o["clip_norm"]
        self.adam, self.ada = o["dense"], o["table"]
        if self.adam["kind"] != "adam" or self.ada["kind"] != "rowwise_adagrad":
            raise ValueError(f"unknown optimizer {o}")
        self.m = {k: torch.zeros_like(t) for k, t in mlp_leaves(w)}
        self.v = {k: torch.zeros_like(t) for k, t in mlp_leaves(w)}
        self.acc = torch.zeros(w["table"].shape[0], dtype=torch.float32,
                               device=w["table"].device)
        self.t = 0
        self.grads: dict[str, torch.Tensor] = {}

    @classmethod
    def resume(cls, cfg: dict, state: dict, precision: str = "fp32"
               ) -> "Trainer":
        """A trainer that continues from ``state``: weights ``w``, Adam's
        ``m``, ``v`` and ``t``, Adagrad's ``acc``, each copied."""
        w = {"table": state["w"]["table"].clone(),
             **{m: {k: [t.clone() for t in state["w"][m][k]]
                    for k in ("b", "w")} for m in ("bot", "top")}}
        tr = cls(cfg, w, precision)
        tr.m = {k: t.clone() for k, t in state["m"].items()}
        tr.v = {k: t.clone() for k, t in state["v"].items()}
        tr.t, tr.acc = state["t"], state["acc"].clone()
        return tr

    def step(self, batch: dict) -> float:
        cfg, w, prec = self.cfg, self.w, self.precision
        dev = batch["dense"].device
        with precision_ctx(prec, dev):
            with torch.no_grad():
                emb = lookup(cfg, w["table"], batch["sparse"])
            leaves = dict(mlp_leaves(w))
            for t in leaves.values():
                t.requires_grad_(True)
            emb.requires_grad_(True)
            with torch.enable_grad():
                loss = bce(head(w, batch["dense"], emb, prec), batch["label"])
                g = torch.autograd.grad(loss, [emb, *leaves.values()])
            for t in leaves.values():
                t.requires_grad_(False)
        with torch.no_grad():
            dense = dict(zip(leaves, g[1:]))
            norm = torch.sqrt(sum(torch.sum(x.float() ** 2)
                                  for x in dense.values()))
            scale = torch.clamp(self.clip / torch.clamp(norm, min=1e-9),
                                max=1.0)
            dense = {k: x * scale for k, x in dense.items()}
            gt = table_grad(cfg, batch["sparse"], g[0], w["table"].shape[0])
            self.grads = {"table": gt, **dense}
            self._update(dense, gt)
        return float(loss.detach())

    def _update(self, dense: dict, gt: torch.Tensor) -> None:
        a, w = self.adam, self.w
        self.t += 1
        bc1 = 1 - a["b1"] ** torch.tensor(float(self.t))
        bc2 = 1 - a["b2"] ** torch.tensor(float(self.t))
        for (k, p) in mlp_leaves(w):
            gk = dense[k]
            self.m[k] = a["b1"] * self.m[k] + (1 - a["b1"]) * gk
            self.v[k] = a["b2"] * self.v[k] + (1 - a["b2"]) * gk * gk
            upd = -a["lr"] * (self.m[k] / bc1.to(p.device)) / (
                torch.sqrt(self.v[k] / bc2.to(p.device)) + a["eps"])
            p += upd.to(p.dtype)
        d = self.ada
        self.acc = self.acc + torch.mean(gt ** 2, dim=1)
        step = -d["lr"] * gt / (torch.sqrt(self.acc)[:, None] + d["eps"])
        w["table"] += step.to(w["table"].dtype)

