"""The port's sequence parallelism over ``torch.distributed`` (gloo, one
process per rank, on the CPU): ``DistComm`` gives exactly ``ThreadComm``'s
result, and ``cli.generate --ulysses_size 2`` runs end to end under
torchrun's environment with only rank 0 writing.

Each test spawns its ranks once (``torch.multiprocessing``, a torch
import each, one intra-op thread each, so that every rank's arithmetic is
the same as a thread rank's). This file imports neither JAX nor the JAX
package; ``test_torch_parallel.py`` holds the port to JAX."""

import os
import socket
import time

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from moviigen_tpu_torch.configs import WAN_CONFIGS
from moviigen_tpu_torch.models.wan_model import WanModel
from moviigen_tpu_torch.ops.rope import rope_3d_freqs
from moviigen_tpu_torch.parallel import sharding
from moviigen_tpu_torch.parallel.comm import run_ranks, thread_mesh
from moviigen_tpu_torch.parallel.mesh import make_mesh
from moviigen_tpu_torch.parallel.ulysses import sequence_parallel_forward

CFG = WAN_CONFIGS["t2v-tiny"].model
GRID = (4, 4, 4)
SPAWN_TIMEOUT_S = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(fn, nprocs, *args):
    """Run ``fn(rank, *args)`` in ``nprocs`` processes; fail (and kill
    them) past ``SPAWN_TIMEOUT_S``."""
    ctx = mp.spawn(fn, args=args, nprocs=nprocs, join=False)
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=1):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"ranks still running after {SPAWN_TIMEOUT_S} s")


def _model(quant):
    gen = torch.Generator().manual_seed(0)
    model = WanModel(CFG, dtype=torch.float32, device="cpu",
                     quant=quant).init_weights(gen)
    with torch.no_grad():
        model.head.weight.normal_(0.0, 0.1, generator=gen)  # live head
    return model


def _inputs():
    gen = torch.Generator().manual_seed(1)
    return (torch.randn(2, CFG.in_dim, 4, 8, 8, generator=gen),
            torch.tensor([500.0, 250.0]),
            torch.randn(2, CFG.text_len, CFG.text_dim, generator=gen))


def _forward(model, comm, sp_mode, fsdp, seq_len):
    if fsdp:
        model = sharding.shard_params(model, sharding.dit_param_specs(model),
                                      comm, sharding.shard_axis(comm))
    with torch.no_grad():
        return sequence_parallel_forward(
            model, *_inputs(), rope_3d_freqs(GRID, CFG.head_dim), comm,
            seq_len=seq_len, compute_dtype=torch.float32, sp_mode=sp_mode,
            fsdp_params=fsdp)


def _sp_worker(rank, world, port, mesh, cases, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        data, ring, seq = mesh
        comm = make_mesh(data=data, ring=ring, seq=seq)
        results = {}
        for name, sp_mode, fsdp, quant, seq_len in cases:
            model = _model(quant)
            results[name] = _forward(model, comm, sp_mode, fsdp, seq_len)
            if rank == 0:  # the same mesh as threads of this process
                for f in dict.fromkeys((fsdp, False)):
                    results[f"{name}/threads/fsdp={f}"] = run_ranks(
                        lambda c: _forward(model, c, sp_mode, f, seq_len),
                        thread_mesh(data=data, ring=ring, seq=seq))
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("mesh,cases", [
    ((1, 1, 2), [("ulysses", "ulysses", False, None, None)]),
    ((1, 1, 2), [("ring", "ring", False, None, 72)]),
    ((1, 2, 2), [("usp", "usp", False, None, None),
                 ("usp_fsdp_int8", "usp", True, "int8", 72),
                 ("usp_fsdp_int4", "usp", True, "int4", None)]),
], ids=["ulysses2", "ring2_padded", "usp2x2_fsdp_int8_int4"])
def test_dist_comm_equals_thread_comm(tmp_path, mesh, cases):
    """Each rank's gloo forward is bit-equal to every thread rank's on the
    same mesh. With ``dit_fsdp`` the block weights (int8 and packed int4
    codes and their scales) are shards gathered per block, and the result
    is bit-equal to the unsharded forward's: the gathered weights are the
    same bytes."""
    world = mesh[0] * mesh[1] * mesh[2]
    _spawn(_sp_worker, world, world, _free_port(), mesh, cases,
           str(tmp_path))
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(world)]
    for name, _, fsdp, _, _ in cases:
        want = ranks[0][f"{name}/threads/fsdp=False"]
        assert len(want) == world and float(want[0].abs().max()) > 0.1
        threads = ranks[0][f"{name}/threads/fsdp={fsdp}"]
        for got in [r[name] for r in ranks] + threads + want:
            assert torch.equal(got, want[0]), name


def _cli_worker(rank, world, port, out_dir):
    from moviigen_tpu_torch.cli import generate
    from moviigen_tpu_torch.models import tokenizer

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    # no tokenizer assets here: skip the transformers import (8 s a rank)
    # that ends in the same hash tokenizer
    tokenizer._huggingface_or_none = lambda **kwargs: None
    os.chdir(out_dir)
    out = generate.main(["--task", "t2v-tiny", "--device", "cpu",
                         "--size", "832*480", "--frame_num", "1",
                         "--sample_steps", "2", "--ulysses_size", "2"])
    with open(os.path.join(out_dir, f"rank{rank}.txt"), "w") as f:
        f.write(repr(out))


def test_cli_generate_ulysses_under_torchrun_env(tmp_path):
    """``cli.generate --device cpu --ulysses_size 2`` with torchrun's
    variables set for two ranks: gloo, a (1, 2) mesh, the sharded umT5
    and DiT, one video written, by rank 0 alone."""
    _spawn(_cli_worker, 2, 2, _free_port(), str(tmp_path))
    said = [(tmp_path / f"rank{r}.txt").read_text() for r in range(2)]
    videos = sorted(p.name for p in tmp_path.iterdir()
                    if p.suffix == ".mp4")
    assert said[1] == "None"
    assert len(videos) == 1 and said[0] == repr(videos[0])
    assert (tmp_path / videos[0]).stat().st_size > 0


def test_cli_fsdp_flags_in_one_process(tmp_path, monkeypatch):
    """``--dit_fsdp --t5_fsdp`` without torchrun: a one-rank mesh, the
    umT5 and the DiT held as (whole) shards and gathered per block, the
    DiT through the sequence-parallel forward. The video is the one the
    same run writes without the flags, bit for bit."""
    from moviigen_tpu_torch.cli import generate
    from moviigen_tpu_torch.models import tokenizer

    monkeypatch.setattr(tokenizer, "_huggingface_or_none",
                        lambda **kwargs: None)
    videos = []

    def keep(video, save_file, **kwargs):
        videos.append(video)
        return save_file

    monkeypatch.setattr(generate, "cache_video", keep)
    argv = ["--task", "t2v-tiny", "--device", "cpu", "--size", "832*480",
            "--frame_num", "5", "--sample_steps", "2", "--base_seed", "7",
            "--save_file", str(tmp_path / "clip.mp4")]
    generate.main(argv + ["--dit_fsdp", "--t5_fsdp"])
    generate.main(argv)
    assert videos[0].shape == (3, 5, 480, 832)
    assert (videos[0] == videos[1]).all()


def test_i2v_sp_forward_equals_one_process():
    """The i2v DiT under Ulysses (2 thread ranks) and ring (2): ``y`` joins
    the latents and ``clip_fea`` the context before the tokens are cut, and
    the 257-token image cross-attention runs on each rank's tokens. Both
    within 1e-5 of the one-process output's scale: the ring's merge
    rounds in fp32, and the products over half the tokens may sum in
    another order (2e-7 here)."""
    cfg = WAN_CONFIGS["i2v-tiny"].model
    gen = torch.Generator().manual_seed(0)
    model = WanModel(cfg, dtype=torch.float32, device="cpu").init_weights(gen)
    with torch.no_grad():
        model.head.weight.normal_(0.0, 0.1, generator=gen)
    x = torch.randn(2, 4, 4, 8, 8, generator=gen)
    y = torch.randn(2, cfg.in_dim - 4, 4, 8, 8, generator=gen)
    clip_fea = torch.randn(2, 257, 1280, generator=gen)
    t, ctx = torch.tensor([500.0, 250.0]), torch.randn(
        2, cfg.text_len, cfg.text_dim, generator=gen)
    rope = rope_3d_freqs(GRID, cfg.head_dim)
    with torch.no_grad():
        want = model(x, t, ctx, rope, compute_dtype=torch.float32,
                     clip_fea=clip_fea, y=y)
        for sp_mode in ("ulysses", "ring"):
            outs = run_ranks(lambda c: sequence_parallel_forward(
                model, x, t, ctx, rope, c, compute_dtype=torch.float32,
                sp_mode=sp_mode, clip_fea=clip_fea, y=y), thread_mesh(seq=2))
            assert float(want.abs().max()) > 0.1
            for got in outs:
                assert float((got - want).abs().max()) \
                    <= 1e-5 * float(want.abs().max())


def test_thread_ranks_under_a_short_switch_interval():
    """Thread ranks share the launch counters and the rendezvous: 16
    ranks (more than the cores) with the interpreter switching threads
    every microsecond, each counting 200 launches and gathering after
    each, lose no count and read every peer's tensor of that round."""
    import sys

    from moviigen_tpu_torch import kernels
    from moviigen_tpu_torch.ops import flash_attention as fa

    def rank(comm):
        for i in range(200):
            kernels.count_launch(fa.flash_attention, "dq_launches")
            got = comm.all_gather(torch.tensor([comm.rank * 1000 + i]),
                                  "seq", 0)
            assert got.tolist() == [r * 1000 + i for r in range(16)]
        return True

    interval = sys.getswitchinterval()
    fa.reset_launch_counts()
    sys.setswitchinterval(1e-6)
    try:
        assert all(run_ranks(rank, thread_mesh(seq=16, timeout=60)))
    finally:
        sys.setswitchinterval(interval)
    assert fa.launch_counts()["dq_launches"] == 16 * 200
    fa.reset_launch_counts()
