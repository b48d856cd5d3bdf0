"""Kernel B3, the pairwise-exchange QAP sweep: wrapper of
``csrc/qap_sweep.cu``.

The counterpart of ``repro.kernels.qap_sweep.qap_sweep_pallas`` with its
whole control interface: per-block ``T``, ``seed``, ``step0``,
``chain_base`` and ``live``, and per-block flow and distance matrices, each
packed ``(n_blocks * n, n)`` or one ``(n, n)`` for every block.  A block is
``blk`` consecutive chains (a serving slot).  The eager errors are the
reference's, plus the kernel's largest ``n``.

For a CUDA tensor the wrapper launches the kernel; for a CPU tensor it
expands the per-block operands and controls to per-chain ones and runs the
plain version, ``ref.qap_sweep_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref
from repro_torch.kernels import rng
from repro_torch.kernels.metropolis_sweep import _per_block, control_arg

#: Largest permutation length the kernel takes (``QAP_MAX_N`` in
#: ``csrc/qap_sweep.cu``): its shared memory holds 256 permutations of
#: up to this many locations, and F and D.
MAX_N = 32


class _Count:
    """Kernel launches on the card."""

    def __init__(self):
        self.launches = 0


counter = _Count()


def _prepare(p, F_blocks, D_blocks, T, seed, step0, blk, chain_base, live):
    """The reference's eager checks.  Returns (F, D) as float32 on p's
    device, each ``(n, n)`` or ``(n_blocks * n, n)``."""
    if p.ndim != 2 or p.dtype != torch.int32:
        raise ValueError(f"p must be (chains, n) int32, not {tuple(p.shape)} {p.dtype}")
    chains, n = p.shape
    if not 1 <= n <= MAX_N:
        raise ValueError(f"permutation length n={n} outside the kernel's "
                         f"range [1, {MAX_N}]")
    if chains % blk:
        raise ValueError(
            f"chains={chains} must be a multiple of blk={blk} for the QAP "
            "sweep (the engine packs whole slots)")
    n_blocks = chains // blk

    def pack(M, name):
        M = torch.as_tensor(M, dtype=torch.float32, device=p.device)
        if tuple(M.shape) not in ((n, n), (n_blocks * n, n)):
            raise ValueError(
                f"{name} must be (n, n) or (n_blocks*n, n) = "
                f"({n_blocks * n}, {n}); got {tuple(M.shape)}")
        return M.contiguous()

    F, D = pack(F_blocks, "F_blocks"), pack(D_blocks, "D_blocks")
    for name, v in (("T", T), ("seed", seed), ("step0", step0),
                    ("chain_base", chain_base), ("live", live)):
        if v is not None:
            _per_block(v, n_blocks, name)
    return F, D


def qap_sweep_kernel(p, F_blocks, D_blocks, T, seed, step0, *, n_steps: int,
                     blk: int, chain_base=None, live=None, out=None):
    """Run an N-step pairwise-exchange sweep for all chains of ``p``
    (chains, n) int32: kernel B3 for a CUDA tensor, the plain version for
    a CPU one.

    ``T``, ``seed``, ``step0`` are scalars or one entry per block;
    ``chain_base`` and ``live`` one entry per block.  ``out``, when given,
    is a (chains, n) int32 tensor that receives the permutations.
    Returns (p_out (chains, n) int32, f_out (chains,) float32)."""
    if p.device.type == "cpu":
        po, fo = qap_sweep_plain(p, F_blocks, D_blocks, T, seed, step0,
                                 n_steps=n_steps, blk=blk,
                                 chain_base=chain_base, live=live)
        return (po if out is None else out.copy_(po)), fo
    if p.device.type != "cuda":
        raise ValueError(f"qap_sweep_kernel: unsupported device {p.device}")
    F, D = _prepare(p, F_blocks, D_blocks, T, seed, step0, blk, chain_base,
                    live)
    return _launch(p.contiguous(), F, D, T, seed, step0, n_steps, blk,
                   chain_base, live, out)


def qap_sweep_plain(p, F_blocks, D_blocks, T, seed, step0, *, n_steps: int,
                    blk: int, chain_base=None, live=None):
    """The plain PyTorch version of :func:`qap_sweep_kernel`, on p's
    device: per-block operands and controls expand to per-chain ones for
    ``ref.qap_sweep_ref``."""
    F, D = _prepare(p, F_blocks, D_blocks, T, seed, step0, blk, chain_base,
                    live)
    dev = p.device
    chains, n = p.shape
    n_blocks = chains // blk

    def expand(v, dtype):  # scalar or per-block -> per-chain
        a = (rng.as_u32(v, dev) if dtype is torch.int64
             else torch.as_tensor(v, device=dev).to(dtype)).reshape(-1)
        return a.expand(chains) if a.numel() == 1 else a.repeat_interleave(blk)

    def per_chain(M):  # (n, n) broadcasts inside ref.qap_sweep_ref
        if M.shape[0] == n:
            return M
        return M.reshape(n_blocks, n, n).repeat_interleave(blk, dim=0)

    lane = torch.arange(blk, device=dev).repeat(n_blocks)
    base = (torch.arange(n_blocks, device=dev) * blk if chain_base is None
            else rng.as_u32(chain_base, dev).reshape(-1).expand(n_blocks))
    cidx = (base.repeat_interleave(blk) + lane) & rng.MASK32
    return ref.qap_sweep_ref(
        p, per_chain(F), per_chain(D), expand(T, torch.float32),
        expand(seed, torch.int64), expand(step0, torch.int64),
        n_steps=n_steps, cidx=cidx,
        live=None if live is None else expand(live, torch.int32))


def _launch(p, F, D, T, seed, step0, n_steps, blk, chain_base, live, out):
    dev = p.device
    chains, n = p.shape
    p_out = torch.empty_like(p) if out is None else out
    if p_out.shape != p.shape or p_out.dtype != torch.int32 \
            or p_out.device != dev or not p_out.is_contiguous():
        raise ValueError("out must be a contiguous int32 tensor shaped like p "
                         "on p's device")
    f_out = torch.empty(chains, dtype=torch.float32, device=dev)
    keep = []  # device arrays that must outlive the launch call

    def arg(v, dtype, by_value=True):
        return control_arg(v, dtype, dev, chains // blk, keep, by_value)

    lib = _build.lib()
    with torch.cuda.device(dev):
        rc = lib.sa_qap_sweep(
            p.data_ptr(), p_out.data_ptr(), f_out.data_ptr(),
            F.data_ptr(), D.data_ptr(), int(F.shape[0] != n),
            int(D.shape[0] != n),
            *arg(T, torch.float32), *arg(seed, torch.int64),
            *arg(step0, torch.int64),
            arg(chain_base, torch.int64, by_value=False)[0],
            arg(live, torch.int32, by_value=False)[0],
            chains, n, blk, n_steps,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "qap_sweep")
    counter.launches += 1
    return p_out, f_out
