"""Gradio web UI for text→video generation on one card.

The port's counterpart of ``moviigen_tpu/apps/gradio_t2v.py`` (parity
target: ``gradio/t2v_14B_singleGPU.py``) — prompt box with a "Prompt
Enhance" button (local Qwen rewriter or DashScope), resolution dropdown,
steps/guidance/shift/seed sliders, negative prompt, video output — over
the port's ``WanT2V`` on ``--device`` (default ``cuda``). Gradio is an
optional dependency; ``main`` exits with a clear message when it is
absent.

Run: ``python -m moviigen_tpu_torch.apps.gradio_t2v --ckpt_dir <dir>``
"""

from __future__ import annotations

import argparse
import logging

from ..configs import SIZE_CONFIGS, SUPPORTED_SIZES, WAN_CONFIGS
from ..utils.io import cache_video


def build_app(args):
    """The UI over a ``WanT2V`` for ``args.task`` on ``args.device``: a
    Prompt Enhance button (prompt, language → prompt) and a Generate
    button (7 inputs → the mp4's path, written as ``example.mp4`` in the
    current directory)."""
    import gradio as gr

    from ..pipelines.text2video import WanT2V
    from ..utils.prompt_extend import build_prompt_expander

    cfg = WAN_CONFIGS[args.task]
    pipe = WanT2V(config=cfg, checkpoint_dir=args.ckpt_dir,
                  device=args.device)
    expander = None

    def prompt_enhance(prompt, tar_lang):
        nonlocal expander
        if expander is None:
            expander = build_prompt_expander(
                args.prompt_extend_method,
                model_name=args.prompt_extend_model, device=args.device)
        out = expander(prompt, tar_lang=tar_lang)
        return out.prompt if out.status else prompt

    def generate(prompt, size, steps, guide_scale, shift, seed, n_prompt):
        video = pipe.generate(
            prompt, size=SIZE_CONFIGS[size], frame_num=args.frame_num,
            shift=shift, sampling_steps=int(steps),
            guide_scale=guide_scale, n_prompt=n_prompt, seed=int(seed))
        path = cache_video(video, save_file="example.mp4",
                           fps=cfg.sample_fps)
        return path

    with gr.Blocks(title="MoviiGen — Text to Video") as demo:
        gr.Markdown("## MoviiGen 1.1 (PyTorch/CUDA) — Text → Video")
        with gr.Row():
            with gr.Column():
                prompt = gr.Textbox(label="Prompt", lines=4)
                with gr.Row():
                    tar_lang = gr.Radio(["ch", "en"], value="ch",
                                        label="Enhance language")
                    enhance = gr.Button("Prompt Enhance")
                size = gr.Dropdown(
                    list(SUPPORTED_SIZES[args.task]),
                    value="1280*720", label="Resolution (W*H)")
                steps = gr.Slider(1, 100, value=50, step=1,
                                  label="Sampling steps")
                guide = gr.Slider(1.0, 20.0, value=5.0, step=0.5,
                                  label="Guidance scale")
                shift = gr.Slider(1.0, 10.0, value=5.0, step=0.5,
                                  label="Shift")
                seed = gr.Number(value=-1, label="Seed (-1 = random)")
                n_prompt = gr.Textbox(label="Negative prompt", lines=2)
                run = gr.Button("Generate", variant="primary")
            with gr.Column():
                out_video = gr.Video(label="Generated video")
        enhance.click(prompt_enhance, inputs=[prompt, tar_lang],
                      outputs=[prompt])
        run.click(generate,
                  inputs=[prompt, size, steps, guide, shift, seed,
                          n_prompt],
                  outputs=[out_video])
    return demo


def main(argv=None):
    p = argparse.ArgumentParser(description="Gradio T2V web UI")
    p.add_argument("--task", type=str, default="t2v-14B")
    p.add_argument("--ckpt_dir", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to serve on (default: cuda)")
    p.add_argument("--frame_num", type=int, default=81)
    p.add_argument("--prompt_extend_method", type=str,
                   default="local_qwen",
                   choices=["dashscope", "local_qwen"])
    p.add_argument("--prompt_extend_model", type=str, default=None)
    p.add_argument("--server_name", type=str, default="0.0.0.0")
    p.add_argument("--server_port", type=int, default=7860)
    args = p.parse_args(argv)

    try:
        import gradio  # noqa: F401
    except ImportError:
        raise SystemExit(
            "gradio is not installed in this environment; "
            "`pip install gradio` on a host with network access")

    demo = build_app(args)
    demo.launch(server_name=args.server_name, server_port=args.server_port)


if __name__ == "__main__":
    main()
