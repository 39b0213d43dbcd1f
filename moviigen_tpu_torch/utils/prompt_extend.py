"""LLM prompt rewriting before generation.

The port's own copy of ``moviigen_tpu/utils/prompt_extend.py``: the same
classes, messages and system prompts, with the local rewriter's LM on
``device`` (default ``cuda``). ``transformers`` and ``dashscope`` are
imported at first use; without them, or without the rewriter's weights,
``extend`` returns ``status=False`` and the prompt unchanged.

Parity: ``wan/utils/prompt_extend.py`` — ``PromptExpander`` base with a
local Qwen rewriter (``QwenPromptExpander``; default model
``ZuluVision/MoviiGen1.1_Prompt_Rewriter``, a Qwen2.5-7B fine-tune) and a
DashScope API variant. The rewriter is an HF/transformers call, not part
of the video model's compute path.

The reference's ``DashScopePromptExpander`` is referenced but never
defined (broken import, prompt_extend.py:219 / gradio app) — here it
exists and degrades gracefully when the ``dashscope`` SDK or API key is
absent.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import torch

LM_CH_SYS_PROMPT = (
    "你是一位Prompt优化师，旨在将用户输入改写为优质Prompt，使其更完整、更具表现力，同时不改变原意。"
    "你需要综合用户输入的内容，生成一段电影级画面描述，包含主体、场景、动作、镜头语言、光影与氛围，"
    "字数控制在80-100字左右，直接输出改写后的描述，不要输出多余解释。"
)

LM_EN_SYS_PROMPT = (
    "You are a prompt optimization specialist. Rewrite the user's input "
    "into a high-quality cinematic video prompt: keep the original "
    "meaning, add subject, scene, motion, camera language, lighting and "
    "atmosphere. Output only the rewritten prompt, 80-100 words, with no "
    "extra explanations."
)


@dataclasses.dataclass
class PromptOutput:
    """ref prompt_extend.py:25-34."""

    status: bool
    prompt: str
    seed: int
    system_prompt: str
    message: str

    def add_custom_field(self, key: str, value) -> None:
        setattr(self, key, value)


class PromptExpander:
    """ref prompt_extend.py:37-75."""

    def __init__(self, model_name: Optional[str] = None, is_vl: bool = False,
                 **kwargs):
        self.model_name = model_name
        self.is_vl = is_vl

    def extend_with_img(self, prompt, system_prompt, image=None, seed=-1,
                        *args, **kwargs) -> PromptOutput:
        raise NotImplementedError

    def extend(self, prompt, system_prompt, seed=-1, *args,
               **kwargs) -> PromptOutput:
        raise NotImplementedError

    def decide_system_prompt(self, tar_lang: str = "ch") -> str:
        return LM_CH_SYS_PROMPT if tar_lang == "ch" else LM_EN_SYS_PROMPT

    def __call__(self, prompt, tar_lang="ch", image=None, seed=-1,
                 *args, **kwargs) -> PromptOutput:
        # VL dispatch only when the expander is a VL one (ref
        # prompt_extend.py:69-72): a text rewriter given an image ignores
        # it rather than crashing in a processor that takes no images.
        system_prompt = self.decide_system_prompt(tar_lang=tar_lang)
        if image is not None and self.is_vl:
            return self.extend_with_img(
                prompt, system_prompt, image=image, seed=seed,
                *args, **kwargs)
        return self.extend(prompt, system_prompt, seed, *args, **kwargs)


class QwenPromptExpander(PromptExpander):
    """Local Qwen rewriter (ref prompt_extend.py:78-143). The LM runs as a
    transformers call on ``device``; weights load lazily on first use."""

    DEFAULT_MODEL = "ZuluVision/MoviiGen1.1_Prompt_Rewriter"
    DEFAULT_VL_MODEL = "Qwen/Qwen2.5-VL-7B-Instruct"

    def __init__(self, model_name: Optional[str] = None, device="cuda",
                 **kwargs):
        if model_name is None:
            model_name = self.DEFAULT_VL_MODEL if kwargs.get("is_vl") \
                else self.DEFAULT_MODEL
        super().__init__(model_name, **kwargs)
        self.device = device
        self._model = None
        self._tokenizer = None

    def _load(self):
        if self._model is not None:
            return
        if self.is_vl:
            # VL rewriter (ref prompt_extend.py:145-204): processor +
            # vision-language model; vision inputs via utils.qwen_vl
            from transformers import AutoModelForVision2Seq, AutoProcessor

            self._tokenizer = AutoProcessor.from_pretrained(self.model_name)
            self._model = AutoModelForVision2Seq.from_pretrained(
                self.model_name, torch_dtype="auto").to(self.device)
            return
        from transformers import AutoModelForCausalLM, AutoTokenizer

        self._tokenizer = AutoTokenizer.from_pretrained(self.model_name)
        self._model = AutoModelForCausalLM.from_pretrained(
            self.model_name, torch_dtype="auto").to(self.device)

    def extend(self, prompt, system_prompt, seed=-1, *args,
               **kwargs) -> PromptOutput:
        try:
            self._load()
        except Exception as e:
            return PromptOutput(
                status=False, prompt=prompt, seed=seed,
                system_prompt=system_prompt,
                message=f"failed to load rewriter model: {e}")
        messages = [
            {"role": "system", "content": system_prompt},
            {"role": "user", "content": prompt},
        ]
        text = self._tokenizer.apply_chat_template(
            messages, tokenize=False, add_generation_prompt=True)
        inputs = self._tokenizer([text], return_tensors="pt").to(self.device)
        with torch.no_grad():
            out = self._model.generate(**inputs, max_new_tokens=512)
        out = out[0][inputs.input_ids.shape[1]:]
        expanded = self._tokenizer.decode(out, skip_special_tokens=True)
        return PromptOutput(
            status=True, prompt=expanded.strip(), seed=seed,
            system_prompt=system_prompt, message="")

    def extend_with_img(self, prompt, system_prompt, image=None, seed=-1,
                        *args, **kwargs) -> PromptOutput:
        """Image-conditioned rewrite through a Qwen-VL model
        (ref prompt_extend.py:145-204)."""
        try:
            self._load()
        except Exception as e:
            return PromptOutput(
                status=False, prompt=prompt, seed=seed,
                system_prompt=system_prompt,
                message=f"failed to load VL rewriter model: {e}")
        from .qwen_vl import process_vision_info

        messages = [
            {"role": "system",
             "content": [{"type": "text", "text": system_prompt}]},
            {"role": "user",
             "content": [{"type": "image", "image": image},
                         {"type": "text", "text": prompt}]},
        ]
        text = self._tokenizer.apply_chat_template(
            messages, tokenize=False, add_generation_prompt=True)
        image_inputs, video_inputs = process_vision_info(messages)
        inputs = self._tokenizer(
            text=[text], images=image_inputs, videos=video_inputs,
            padding=True, return_tensors="pt").to(self.device)
        with torch.no_grad():
            out = self._model.generate(**inputs, max_new_tokens=512)
        trimmed = out[0][inputs.input_ids.shape[1]:]
        expanded = self._tokenizer.batch_decode(
            [trimmed], skip_special_tokens=True,
            clean_up_tokenization_spaces=False)[0]
        return PromptOutput(
            status=True, prompt=expanded.strip(), seed=seed,
            system_prompt=system_prompt, message="")


class DashScopePromptExpander(PromptExpander):
    """DashScope API rewriter (the reference references this class but
    never defines it — §2.2 drift; implemented here for completeness)."""

    def __init__(self, api_key: Optional[str] = None,
                 model_name: str = "qwen-plus", **kwargs):
        super().__init__(model_name, **kwargs)
        self.api_key = api_key

    def extend(self, prompt, system_prompt, seed=-1, *args,
               **kwargs) -> PromptOutput:
        try:
            import dashscope

            if self.api_key:
                dashscope.api_key = self.api_key
            rsp = dashscope.Generation.call(
                self.model_name,
                messages=[
                    {"role": "system", "content": system_prompt},
                    {"role": "user", "content": prompt},
                ],
                result_format="message")
            expanded = rsp.output.choices[0].message.content
            return PromptOutput(
                status=True, prompt=expanded.strip(), seed=seed,
                system_prompt=system_prompt, message="")
        except Exception as e:
            return PromptOutput(
                status=False, prompt=prompt, seed=seed,
                system_prompt=system_prompt,
                message=f"dashscope unavailable: {e}")


def build_prompt_expander(method: str, model_name: Optional[str] = None,
                          task: str = "t2v-14B", **kwargs) -> PromptExpander:
    # i2v tasks get the VL rewriter (ref generate.py:231-235 passes
    # is_vl="i2v" in task)
    kwargs.setdefault("is_vl", "i2v" in task)
    if method == "dashscope":
        return DashScopePromptExpander(model_name=model_name, **kwargs)
    if method == "local_qwen":
        return QwenPromptExpander(model_name=model_name, **kwargs)
    raise ValueError(f"unknown prompt_extend_method: {method}")
