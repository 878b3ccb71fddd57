"""Train a tiny causal LM on the induction task, with the sequence axis
sharded over the mesh when it has several ranks.

Counterpart of the JAX package's ``examples/long_context_lm.py``, with
its flags, defaults and output lines. The second half of every sequence
repeats the first, so predicting it well needs attention about S/2
tokens back: watch the half2 loss fall under the half1 (unpredictable)
loss as the induction circuit forms.

``--attention flash`` trains through the three flash-attention kernels
(the forward and both backward kernels, once a layer and sequence); on a
mesh of several ranks (the ``mesh_shape`` setting, e.g.
``FIBER_MESH_SHAPE=4``) each rank's block of the ring runs them.
``ring`` and ``ulysses`` shard the sequence over the mesh's ranks and
attend in plain PyTorch. The batch is a loop over sequences where JAX
vmaps (``make_train_step(batched=True)``). The optimizer is the port's
``adamw`` at ``optax.adamw(lr, weight_decay=0.01)``'s settings.
Weights come from seed 0, the batches from seed 1. The banner counts
the mesh's ranks in JAX's words, as devices, though every rank of the
port's mesh may sit on one card.

Run:  python -m fiber_tpu_torch.examples.long_context_lm [--seq 256]
          [--steps 300] [--attention ring|ulysses|flash] [--device cpu]
"""

import argparse
import math
import sys

#: ``optax.adamw(lr, weight_decay=0.01)``, the JAX example's optimizer
WEIGHT_DECAY = 0.01


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m fiber_tpu_torch.examples.long_context_lm")
    parser.add_argument("--seq", type=int, default=256)
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--vocab", type=int, default=32)
    parser.add_argument("--dim", type=int, default=128)
    parser.add_argument("--layers", type=int, default=2)
    parser.add_argument("--attention", default="ring",
                        choices=("ring", "ulysses", "flash"))
    parser.add_argument("--kv-heads", type=int, default=None,
                        help="GQA: KV heads < heads (flash reads the "
                             "small KV natively; the other planes repeat "
                             "it)")
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    return parser, parser.parse_args(argv)


def build_model(vocab, dim, layers, seq, attention, kv_heads=None,
                device=None, seed=0):
    """The example's TinyLM (8 heads) on ``device``, over the default
    mesh when that has several ranks."""
    import torch

    from fiber_tpu_torch.device import resolve_device
    from fiber_tpu_torch.models.transformer import TinyLM
    from fiber_tpu_torch.parallel.mesh import default_mesh

    dev = resolve_device(device)
    mesh = default_mesh(dev)
    return TinyLM(vocab=vocab, dim=dim, heads=8, layers=layers, max_seq=seq,
                  mesh=mesh if mesh.n_dev > 1 else None, attention=attention,
                  kv_heads=kv_heads, device=dev,
                  generator=torch.Generator().manual_seed(seed))


def make_batch(generator, batch: int, seq: int, vocab: int, device):
    """(batch, seq) int64 tokens whose second half repeats the first,
    drawn on the CPU from ``generator`` and moved to ``device``."""
    import torch

    h = torch.randint(0, vocab, (batch, seq // 2), generator=generator)
    return torch.cat([h, h], dim=1).to(device)


def half_losses(model, tokens):
    """The mean next-token loss over the first half's predictions and
    over the second half's, each averaged over the batch."""
    import torch

    half = tokens.shape[1] // 2
    l1, l2 = [], []
    with torch.no_grad():
        for t in tokens:
            logp = torch.log_softmax(model.apply(t)[:-1], dim=-1)
            nll = -logp.gather(1, t[1:, None])
            l1.append(nll[:half - 1].mean())
            l2.append(nll[half - 1:].mean())
    return torch.stack(l1).mean(), torch.stack(l2).mean()


def main(argv=None) -> int:
    parser, args = parse_args(argv)

    import torch

    from fiber_tpu_torch.device import resolve_device
    from fiber_tpu_torch.models.transformer import adamw, make_train_step
    from fiber_tpu_torch.parallel.mesh import default_mesh

    dev = resolve_device(args.device)
    ranks = default_mesh(dev).n_dev
    if args.seq % 2 or args.seq % ranks:
        parser.error(
            f"--seq must be even (copy task halves) and divisible by "
            f"the {ranks}-rank mesh; got {args.seq}")
    model = build_model(args.vocab, args.dim, args.layers, args.seq,
                        args.attention, args.kv_heads, dev)
    step = make_train_step(
        model, adamw(model.parameters(), args.lr, WEIGHT_DECAY),
        batched=True)
    gen = torch.Generator().manual_seed(1)
    shard = f"{ranks} devices ({args.seq // ranks} tokens/device)"
    plane = (shard if args.attention != "flash"
             else "single device, kernels" if ranks == 1
             else f"ring x flash kernels over {shard}")
    print(f"{args.attention} attention, seq {args.seq} over {plane}")
    for i in range(args.steps):
        tokens = make_batch(gen, args.batch, args.seq, args.vocab, dev)
        loss = step(tokens)
        if i % max(1, args.steps // 10) == 0 or i == args.steps - 1:
            l1, l2 = half_losses(model, tokens)
            print(f"step {i:4d}  loss {float(loss):5.3f}  "
                  f"half1 {float(l1):5.3f} "
                  f"(random={math.log(args.vocab):.3f})  "
                  f"half2 {float(l2):5.3f} <- induction", flush=True)
    print("long-context training done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
