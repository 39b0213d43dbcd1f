"""The serving driver: one ``WanT2V`` on one card, answering text-to-video
requests back to back through ``WanT2V.generate``, as the port's CLI and
its gradio app serve them (one request at a time per card).

A traffic file (``driver: serve``) gives the request: ``size`` [W, H],
``frame_num``, ``sampling_steps``, ``guide_scale``, ``shift``, the
``prompts`` drawn from and the negative prompt ``n_prompt``; and the
check's ``check_latent_frames``, the prefix of latent frames whose video
the reference decodes.

Set-up builds the pipeline, copies the benchmark's weights in and answers
one one-step request at the cell's shape (every kernel the window runs
is built and loaded there). The window then runs requests back to back
from the seed's prompts and noise seeds until ``seconds`` have passed,
finishing the last. After it, one of its requests, drawn from the seed,
is decoded (``WanT2V.decode_request``), the peak memory is read, the
program is freed, and the reference computes that request again.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from . import core, counters, program
from .reference import dit as ref_dit
from .reference import t5 as ref_t5
from .reference import unipc as ref_unipc
from .reference import vae as ref_vae
from .reference.tokenizer import tokenize
from .tracing import Tracer


def reference_text(conf: dict, tr: dict, seed: int, prompt: str, device,
                   fp8: bool = False) -> torch.Tensor:
    """The umT5 embeddings [2, text_len, dim] of the prompt and the
    negative prompt, fp32, zero past each one's length."""
    m, t = conf["model"], conf["t5"]
    ids, mask = tokenize([prompt, tr["n_prompt"]], m["text_len"],
                         t["vocab_size"])
    ids, mask = (torch.as_tensor(a, device=device) for a in (ids, mask))
    return ref_t5.encode(ref_t5.drawn_params(seed, t, device), t, ids, mask,
                         fp8=fp8)


def reference_latent(conf: dict, tr: dict, seed: int, text: torch.Tensor,
                     noise_seed: int, device) -> torch.Tensor:
    """The request's final latent [1, z, F', H', W'] in fp32: the CFG
    denoise from the noise seed, over ``text`` (the embeddings of the
    prompt and of the negative prompt, [2, text_len, dim])."""
    m, v = conf["model"], conf["vae"]
    w, h = tr["size"]
    stride = conf["vae_stride"]
    shape = (v["z_dim"], (tr["frame_num"] - 1) // stride[0] + 1,
             h // stride[1], w // stride[2])
    gen = torch.Generator(device=device).manual_seed(noise_seed)
    x = torch.randn((1, *shape), generator=gen, dtype=torch.float32,
                    device=device)
    steps, shift = tr["sampling_steps"], tr["shift"]
    sched = ref_unipc.UniPC(steps, shift)
    net = ref_dit.Model(ref_dit.drawn_params(seed, m, device, cache={}), m)
    g = tr["guide_scale"]
    for i, ts in enumerate(ref_unipc.timesteps(steps, shift)):
        tt = torch.full((2,), float(ts), device=device)
        vel = ref_dit.forward(net, x.expand(2, *shape), tt, text.float())
        x = sched.step(i, vel[1:] + g * (vel[:1] - vel[1:]), x)
    return x


def reference_video(conf: dict, seed: int, latent: torch.Tensor, frames: int,
                    device, fp8: bool = False) -> torch.Tensor:
    """The fp32 decode of the first ``frames`` latent frames of the
    program's latent [1, z, F', H', W'] → [1, 3, 1 + 4(frames − 1), H,
    W]."""
    dec = ref_vae.Decoder(ref_vae.drawn_params(seed, conf["vae"], device),
                          fp8=fp8)
    return dec.decode(latent[:, :, :frames].float(), conf["vae"])


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """‖a − b‖ / ‖b‖ in float64."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).norm() / b.norm())


class Requests:
    """The seed's requests: a prompt and a noise seed each."""

    def __init__(self, tr: dict, seed: int):
        self.rng = np.random.default_rng([seed, 1])
        self.prompts = tr["prompts"]

    def next(self):
        return (self.prompts[int(self.rng.integers(len(self.prompts)))],
                int(self.rng.integers(0, 2 ** 62)))


def run(bench: core.Bench, cell: dict, seed: int, seconds: float,
        trace: bool, device: str, control: bool = False) -> dict:
    """One run of a serving cell. The check compares three stages of the
    request it draws, each from the program's own input to that stage:
    the umT5 embeddings (``text_rel``), the final latent denoised over the
    program's own embeddings (``latent_rel``), the decode of the program's
    latent (``video_rel``).

    With ``control`` (``control.py``) the result also holds each stage's
    control reading: the request answered again by the program with its
    W8A8 path switched on as ``WanT2V(quant="w8a8")`` sets it (the DiT's
    block linears W8A8 on the int8 GEMM, quantized in place) for the
    latent; the reference with fp8 operands in the program's place for
    the encoder (whose quantized path computes in bf16) and the decode
    (which has none)."""
    from moviigen_tpu_torch.pipelines.text2video import (
        WanT2V, compute_target_shape_and_seq_len)

    conf = bench.config(cell["config"])
    tr = bench.traffic(cell["traffic"])
    limits = bench.limits(cell["name"])
    cuda = device.startswith("cuda")
    cfg = program.pipeline_config(conf)
    size = tuple(tr["size"])
    texts = []

    def request(prompt, noise_seed, steps):
        with torch.profiler.record_function("bench.request"):
            latent = pipe.generate(
                prompt, size=size, frame_num=tr["frame_num"],
                shift=tr["shift"], sample_solver="unipc",
                sampling_steps=steps, guide_scale=tr["guide_scale"],
                n_prompt=tr["n_prompt"], seed=noise_seed,
                return_latents=True)
        return dict(prompt=prompt, noise_seed=noise_seed, text=texts[-1],
                    latent=torch.from_numpy(latent)[None])

    # ---- set-up: the pipeline, the benchmark's weights, one warm request
    core.log("program imported")
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    torch.zeros(1, device=device)
    sync()
    core.log("card ready")
    pipe = WanT2V(cfg, init_seed=0, device=device)
    sync()
    core.log("pipeline built")
    program.load_pipeline(pipe, conf, seed)
    sync()
    core.log("weights drawn")
    if type(pipe.tokenizer).__name__ != "HashTokenizer":
        raise RuntimeError(f"the pipeline tokenizes with "
                           f"{type(pipe.tokenizer).__name__}; the reference "
                           "knows the hash tokenizer only")
    encode_text = pipe.encode_text

    def keep_text(prompts):
        # the encoder's output as the request hands it to the DiT, kept
        # for the check (the pipeline calls self.encode_text)
        texts.append(encode_text(prompts))
        return texts[-1]

    pipe.encode_text = keep_text
    reqs = Requests(tr, seed)
    request(*reqs.next(), steps=1)
    core.log("warm-up request answered")
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    # ---- the window
    tracer = Tracer(trace, cuda)
    tracer.start()
    setup_s = core.process_age()
    done, t5_s = [], []
    t0 = time.perf_counter()
    with tracer.window():
        while True:
            done.append(request(*reqs.next(), tr["sampling_steps"]))
            t5_s.append(pipe.timings["t5_s"])
            if time.perf_counter() - t0 >= seconds:
                break
    window_s = time.perf_counter() - t0
    window = tracer.stop()
    steps = len(done) * tr["sampling_steps"]
    core.log(f"window closed: {len(done)} requests in {window_s:.3f} s")

    # ---- after it: one request decoded, the peak read, the program freed
    pick = done[int(np.random.default_rng([seed, 2]).integers(len(done)))]
    lat = pick["latent"].to(device)
    video = torch.from_numpy(pipe.decode_request(lat))[None]
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if control:
        from moviigen_tpu_torch.ops.quantization import (quantize_t5_params,
                                                         quantize_wan_params)

        quantize_wan_params(pipe.dit, bits=8, act8=True)
        quantize_t5_params(pipe.t5, bits=8)
        w8a8 = request(pick["prompt"], pick["noise_seed"],
                       tr["sampling_steps"])
    core.log("decoded")
    del pipe, encode_text, done
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # ---- the reference: each stage from the program's input to it
    k = tr["check_latent_frames"]
    with torch.no_grad(), ref_dit.exact_fp32():
        text = reference_text(conf, tr, seed, pick["prompt"], device)
        latent = reference_latent(conf, tr, seed, pick["text"],
                                  pick["noise_seed"], device)
        core.log("reference latent")
        vid = reference_video(conf, seed, lat, k, device).cpu()
        core.log("reference decode")
        # a clip of another length than the request's is wrong as a whole
        whole = video.shape[2] == tr["frame_num"]
        readings = {"text_rel": rel(pick["text"], text),
                    "latent_rel": rel(pick["latent"], latent),
                    "video_rel": (rel(video[:, :, :vid.shape[2]], vid)
                                  if whole else float("inf"))}
        ctl = None
        if control:
            ctl = {"text_rel": rel(reference_text(conf, tr, seed,
                                                  pick["prompt"], device,
                                                  fp8=True), text),
                   "latent_rel": rel(w8a8["latent"], reference_latent(
                       conf, tr, seed, w8a8["text"], pick["noise_seed"],
                       device)),
                   "video_rel": rel(reference_video(conf, seed, lat, k,
                                                    device, fp8=True), vid)}
    checks, correct = core.judge(readings, limits)

    m = conf["model"]
    _, tokens, _ = compute_target_shape_and_seq_len(cfg, size,
                                                    tr["frame_num"])
    ops, nbytes = counters.attention_work(m, tokens, batch=2)
    ctx = dict(kind="serve", window_s=window_s, steps=steps,
               requests=len(t5_s), t5_s=t5_s,
               flops=steps * counters.dit_flops(m, tokens, batch=2),
               attn_ops=steps * ops, attn_bytes=steps * nbytes,
               trace=window,
               card_kind=torch.cuda.get_device_name(0) if cuda else None)
    return dict(correct=correct, attempted=len(t5_s), failed=0,
                checks=checks, control=ctl, window=window,
                peak_bytes=peak, ctx=ctx,
                end_to_end={"setup_s": setup_s,
                            "denoise_step_s": window_s / steps,
                            "peak_gib": peak / 2 ** 30})
