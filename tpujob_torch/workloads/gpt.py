"""GPT-style decoder-only causal-LM pretraining: the port of
``tpujob/workloads/gpt.py``.

The trunk of ``tpujob_torch.workloads.bert`` with a causal mask through the
attention path the flags pick (dense torch, or the hand-written flash
kernels), a GPT-2-style ``ln_f`` before the tied head, and next-token
cross-entropy.  Sized GPT-2-medium by default (hidden 1024, 24 layers, 16
heads, vocab 50257 padded to 50304, seq 1024).

Decode, the serving path: ``sample_next`` (greedy, temperature, top-k,
top-p), ``generate`` (the full forward over a fixed buffer at every step;
with ``--attention flash`` on the card it runs the forward kernel; a MoE
model routes only the realized positions) and ``generate_cached`` (one
token a step against a KV cache, dense attention as in the JAX package;
a MoE model falls back to ``generate``).  ``--generate N`` decodes N
tokens after training.

Under ``--sequence-parallel N`` each rank trains on its shard of every
sequence (``bert.seq_positions``) with the targets of the global rows
(``next_token_shard``, ``lm_loss``); decode runs the KV-cached route on
every rank's whole model, as the JAX package's does (the cached route
never runs the sequence-parallel attention).  Under
``--tensor-parallel``, ``--expert-parallel`` or ``--fsdp`` every rank
decodes global row 0's prompt on its shards (the cache holds the rank's
KV heads), all ranks together, to the same tokens.  A MoE model decodes
by the full route on every rank in lockstep, since its FFN exchanges
over the expert and tensor groups (a rank that skipped a step would
leave the others waiting); under ``--sequence-parallel`` each rank
forwards the whole buffer (``Bert``'s ``whole_attention_fn``).  Under
``--pipeline-parallel`` a rank holds its stage's layers only: it trains
through the schedule (``make_f1b`` is the loss a microbatch at a time)
and decodes by the full route through the pipeline
(``bert.pipeline_apply``), every stage to the same tokens.

Entry point (on the card; ``--device cpu`` for the CPU):
    python -m tpujob_torch.workloads.gpt --attention flash --batch-size 8 --steps 5
    torchrun --nproc-per-node 2 -m tpujob_torch.workloads.gpt --device cpu \
        --sequence-parallel 2 --sp-mode ulysses --attention flash ...
    torchrun --nproc-per-node 4 -m tpujob_torch.workloads.gpt --device cpu \
        --fsdp 2 --tensor-parallel 2 ...
    torchrun --nproc-per-node 2 -m tpujob_torch.workloads.gpt --device cpu \
        --moe-experts 4 --expert-parallel 2 ...
    torchrun --nproc-per-node 2 -m tpujob_torch.workloads.gpt --device cpu \
        --pipeline-parallel 2 --pipeline-microbatches 4 \
        --pipeline-schedule 1f1b --attention flash ...
    python -m tpujob_torch.workloads.gpt --steps 1 --generate 32
    python -m tpujob_torch.workloads.gpt --attention flash \
        --data-file corpus.txt --tokenizer bpe:tok.json:512
"""
from __future__ import annotations

import argparse
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from tpujob_torch.workloads import bert as bertlib
from tpujob_torch.workloads import distributed as dist
from tpujob_torch.workloads import train_lib


def lm_loss(model, positions=None, mesh=None):
    """Next-token cross-entropy (shift by one).  The log-softmax runs in
    the logits' dtype (bf16 under --bf16), as in the JAX package.  A MoE
    model adds the aux terms as ``bert.mlm_loss`` does.

    With ``positions`` (a sequence shard's, ``bert.seq_positions``) the
    batch is ``next_token_shard``'s ``(ids, targets, valid)``: the targets
    come from the global row, so the pair that straddles two shards is
    kept, and the global sequence's last position (no target) is left out.
    The sum is over the shard and the count is the global batch's, scaled
    by the number of token shards (``mesh``'s, or the world), so the
    ranks' mean is the global mean, as in ``bert.mlm_loss``."""

    def loss_fn(batch):
        if positions is None:
            (ids,) = batch  # [b, s] int64
            logits, terms = bertlib.moe_forward(model, ids, loss_fn,
                                                mesh=mesh)
            logp = torch.log_softmax(logits[:, :-1], dim=-1)
            tok_ll = torch.gather(logp, -1, ids[:, 1:, None])[..., 0]
            return bertlib.with_moe_aux(-tok_ll.mean(), terms)
        ids, targets, valid = batch
        logits, terms = bertlib.moe_forward(model, ids, loss_fn, positions,
                                            mesh)
        logp = torch.log_softmax(logits, dim=-1)
        tok_ll = torch.gather(logp, -1, targets[..., None])[..., 0]
        count = train_lib.global_sum(valid.sum(), mesh)
        loss = -(tok_ll * valid).sum() * dist.token_shards(mesh) / count
        return bertlib.with_moe_aux(loss, terms)

    return loss_fn


def next_token_shard(rows: np.ndarray, pos: np.ndarray) -> tuple:
    """``(ids, targets, valid)`` of a sequence shard of ``rows`` [b, S] at
    the global positions ``pos``: each token, the global row's next token
    (its own at the last position), and 1.0 where a target exists."""
    last = rows.shape[1] - 1
    valid = np.broadcast_to((pos < last).astype(np.float32),
                            (rows.shape[0], len(pos)))
    return rows[:, pos], rows[:, np.minimum(pos + 1, last)], valid


def make_f1b(micro: int, shards: int):
    """The causal LM a microbatch at a time, for the pipeline
    (``bert.train``): the shift-by-one token mean of each microbatch.
    Their token counts are equal, so the mean over the microbatches is the
    rank's mean and no scaling is needed (``micro`` and ``shards`` are
    unused, as in the JAX package)."""

    def preprocess(batch):
        (ids,) = batch
        return ids, (ids,)

    def head_loss(logits, extra):
        (ids,) = extra
        logp = torch.log_softmax(logits[:, :-1], dim=-1)
        return -torch.gather(logp, -1, ids[:, 1:, None])[..., 0].mean()

    return preprocess, head_loss


def sample_next(logit: torch.Tensor, rng: Optional[torch.Generator], *,
                temperature: float = 0.0, top_k: int = 0,
                top_p: float = 0.0) -> torch.Tensor:
    """One sampling decision over [batch, vocab] logits, the policy both
    decode routes share.  ``temperature`` 0 is greedy argmax (top-k/top-p
    ignored); otherwise a draw from ``rng`` over the softmax of the logits
    that ``truncate`` keeps."""
    if temperature <= 0.0:
        return torch.argmax(logit, dim=-1)
    logit = truncate(logit, temperature=temperature, top_k=top_k, top_p=top_p)
    probs = torch.softmax(logit.float(), dim=-1)
    return torch.multinomial(probs, 1, generator=rng)[:, 0]


def truncate(logit: torch.Tensor, *, temperature: float, top_k: int = 0,
             top_p: float = 0.0) -> torch.Tensor:
    """``logit / temperature`` with the dropped tokens set to -inf:
    ``top_k`` keeps every logit >= the k-th highest (ties kept);
    ``top_p`` keeps each token whose PRECEDING mass in the sorted
    distribution is < p (the token that crosses p stays in) and cuts at
    the least kept logit, ties kept (``gpt.py`` ``sample_next``)."""
    logit = logit / temperature
    if top_k > 0:
        kth = torch.topk(logit, top_k, dim=-1).values[..., -1:]
        logit = logit.masked_fill(logit < kth, float("-inf"))
    if top_p > 0.0:
        sorted_logit = torch.sort(logit, dim=-1, descending=True).values
        csum = torch.cumsum(torch.softmax(sorted_logit, dim=-1), dim=-1)
        keep = torch.cat([torch.ones_like(csum[..., :1], dtype=torch.bool),
                          csum[..., :-1] < top_p], dim=-1)
        cutoff = torch.where(keep, sorted_logit,
                             float("inf")).amin(dim=-1, keepdim=True)
        logit = logit.masked_fill(logit < cutoff, float("-inf"))
    return logit


def _decode_buffer(model, prompt: torch.Tensor, max_new_tokens: int,
                   temperature: float, rng) -> torch.Tensor:
    """The checks both routes share, and the [b, prompt + new] id buffer
    with the prompt written in."""
    b, p = prompt.shape
    total = p + max_new_tokens
    if total > model.max_seq:
        raise ValueError(
            f"prompt {p} + max_new_tokens {max_new_tokens} exceeds the "
            f"model's max_seq {model.max_seq}")
    if temperature > 0 and rng is None:
        raise ValueError("temperature > 0 sampling needs an rng generator")
    buf = torch.zeros((b, total), dtype=torch.long, device=prompt.device)
    buf[:, :p] = prompt
    return buf


def generate(model, prompt: torch.Tensor, max_new_tokens: int, *,
             temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
             rng: Optional[torch.Generator] = None,
             forward: Optional[Callable] = None) -> torch.Tensor:
    """Autoregressive decode by the full forward over a fixed buffer at
    every step: the causal mask makes the positions past the cursor inert.
    For a MoE model the attention mask is not enough (positions past the
    cursor would compete for expert capacity and could evict a realized
    token's assignment), so a validity mask stops routing there too.
    Under ``no_grad``, so with flash attention on the card each step is one
    forward-kernel launch a layer and no backward.  ``forward(ids,
    valid=...)`` computes the logits (default ``model``; a pipeline stage
    passes ``bert.pipeline_apply``'s, every stage then holding them).
    Returns [b, prompt + max_new_tokens] ids."""
    forward = forward or model
    buf = _decode_buffer(model, prompt, max_new_tokens, temperature, rng)
    b, total = buf.shape
    p = prompt.shape[1]
    positions = torch.arange(total, device=buf.device)
    with torch.no_grad():
        for i in range(max_new_tokens):
            valid = None
            if model.moe is not None:
                # positions [0, p+i) are realized; the rest must not route
                valid = (positions < p + i).float().expand(b, total)
            # token i is written at position p+i, predicted from p+i-1
            logit = forward(buf, valid=valid)[:, p + i - 1]
            buf[:, p + i] = sample_next(logit, rng, temperature=temperature,
                                        top_k=top_k, top_p=top_p)
    return buf


def generate_cached(model, prompt: torch.Tensor, max_new_tokens: int, *,
                    temperature: float = 0.0, top_k: int = 0,
                    top_p: float = 0.0,
                    rng: Optional[torch.Generator] = None) -> torch.Tensor:
    """KV-cached decode: one position a step against a cache sized to the
    decode (``Bert.new_cache``), attention dense whatever the training
    attention path.  One loop covers prefill and generation: prompt
    positions feed the known token, later ones the sampled one.  The cache
    is made here and dropped at the end: nothing survives the call.

    A MoE model decodes by ``generate`` instead: capacity depends on the
    sequence length (a one-token step never drops an assignment where the
    whole forward may), so the cached route would be another function."""
    if model.moe is not None:
        return generate(model, prompt, max_new_tokens,
                        temperature=temperature, top_k=top_k, top_p=top_p,
                        rng=rng)
    buf = _decode_buffer(model, prompt, max_new_tokens, temperature, rng)
    b, p = prompt.shape
    cache = model.new_cache(b, buf.shape[1])
    with torch.no_grad():
        for i in range(buf.shape[1] - 1):
            logits, cache = model(buf[:, i : i + 1], cache=cache)
            if i + 1 >= p:  # within the prompt the next token is known
                buf[:, i + 1] = sample_next(
                    logits[:, 0], rng, temperature=temperature, top_k=top_k,
                    top_p=top_p)
    return buf


def build_parser() -> argparse.ArgumentParser:
    """The BERT flag surface with decoder defaults (GPT-2-medium shapes,
    GPT-2 vocab) and the decode flags."""
    p = bertlib.build_parser()
    p.description = "GPT (decoder-only) causal-LM pretrain (PyTorch port)"
    p.set_defaults(vocab=50257, seq_len=1024)
    p.add_argument("--generate", type=int, default=0, metavar="N",
                   help="after training, decode N tokens from a "
                        "training-batch prefix and print the ids")
    p.add_argument("--generate-temperature", type=float, default=0.0,
                   help="0 = greedy; > 0 samples from the softmax")
    p.add_argument("--generate-top-k", type=int, default=0,
                   help="sample only from the k highest logits (0 = off)")
    p.add_argument("--generate-top-p", type=float, default=0.0,
                   help="nucleus sampling: smallest prefix of the sorted "
                        "distribution reaching this mass (0 = off)")
    return p


def build_model(args, device, mesh=None):
    return bertlib.build_model(args, device, causal=True, final_ln=True,
                               mesh=mesh)


def run(args, *, on_step: Optional[Callable[[int], None]] = None,
        capture: bool = True) -> Dict[str, Any]:
    """Train from the flags (synthetic ids, or with ``--data-file`` /
    ``--tokenizer`` a corpus batch a step), then with ``--generate N``
    decode N tokens (KV-cached) from the first ids of global row 0 (the
    corpus' first chunk on a corpus) and print them; the ids are also
    returned as ``generated``: every process decodes on its unwrapped
    model, process 0 prints.  ``on_step(i)`` runs after each step and
    ``capture=False`` keeps the card's step eager (see ``bert.train``)."""
    device = dist.local_device(getattr(args, "device", "cuda"))
    pe = dist.initialize(device=device)
    n_gen = getattr(args, "generate", 0)
    temp = getattr(args, "generate_temperature", 0.0)
    # both checks fail BEFORE training, not after the whole run
    if n_gen >= args.seq_len:
        raise ValueError(
            f"--generate {n_gen} must leave room for a prompt within "
            f"--seq-len {args.seq_len} (need generate <= seq-len - 1)")
    if temp <= 0.0 and (getattr(args, "generate_top_k", 0)
                        or getattr(args, "generate_top_p", 0.0)):
        # greedy decode ignores the truncation flags: never drop one
        raise ValueError(
            "--generate-top-k/--generate-top-p need "
            "--generate-temperature > 0 (greedy decode samples nothing)")
    tok = bertlib.tokenizer_from_args(args)
    mesh = bertlib.make_mesh_for(args, pe)
    model = build_model(args, device, mesh=mesh)
    ids0, provider, sample = bertlib.token_batches(args, pe, tokenizer=tok,
                                                   mesh=mesh)
    pos = bertlib.seq_positions(args, mesh, causal=True)

    def shard(rows):
        return (rows,) if pos is None else next_token_shard(rows, pos)

    bp = None if provider is None else (lambda step: shard(provider(step)))
    positions = None if pos is None else torch.from_numpy(pos).to(device)
    result = bertlib.train(args, pe, model,
                           lambda net: lm_loss(net, positions=positions,
                                               mesh=mesh),
                           train_lib.put_batch(shard(ids0), device),
                           tag="gpt", batch_provider=bp, on_step=on_step,
                           capture=capture, mesh=mesh, make_f1b=make_f1b)
    if n_gen > 0:
        prompt = bertlib.batch_to_device(
            sample[:, : min(8, args.seq_len - n_gen)], device)
        rng = None
        if temp > 0:
            rng = torch.Generator(device=device).manual_seed(args.seed)
        decode = dict(temperature=temp,
                      top_k=getattr(args, "generate_top_k", 0),
                      top_p=getattr(args, "generate_top_p", 0.0), rng=rng)
        if mesh.size("pipeline") > 1:
            # a stage holds its layers only: the full route through the
            # pipeline, one microbatch (the prompt is one row)
            out = generate(model, prompt, n_gen, **decode, forward=(
                lambda ids, valid=None: bertlib.pipeline_apply(
                    model, ids, mesh, 1)))
        else:
            out = generate_cached(model, prompt, n_gen, **decode)
        if getattr(model, "fsdp_mesh", None) is not None:
            # FSDP keeps the root's parameters gathered after a forward
            # with no backward: shard them again
            model.reshard()
        if pe.process_id == 0:
            print(f"generated ids: {out[0].tolist()}")
        result["generated"] = out
    return result


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    run(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
