"""Supervised preprocessing: templates, tokenization, label masking
(port of `video_llava_seg_torch/data/preprocess.py`, pinned to it by
`tests/test_torch_data.py`).

`preprocess_multimodal` expands <video> into the slow-fast <image> layout;
the per-template tokenizers mask the human turns with IGNORE_INDEX
(`preprocess_llama3`, `_v1`, `_llama_2`, `_mpt`, `_plain`), with the same
label-span arithmetic, its +-1 corrections and its "tokenization
mismatch" rule. numpy arrays out. The tokenizer is the port's
(`video_llava_seg_torch/tokenizer.py`) or any object with the same
surface.

As in the JAX package, the mpt round arithmetic never counts the final
<|im_end|>, so the mismatch rule masks every label of a well-formed mpt
sample (the reference's behaviour, kept).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence

import numpy as np

from video_llava_seg_torch import conversation as conversation_lib
from video_llava_seg_torch.constants import (
    DEFAULT_IM_END_TOKEN,
    DEFAULT_IM_START_TOKEN,
    DEFAULT_IMAGE_TOKEN,
    DEFAULT_VIDEO_TOKEN,
    IGNORE_INDEX,
    SLOW_FAST_SEPARATOR_TOKEN,
    VIDEO_SEG_TOKEN,
)
from video_llava_seg_torch.mm_utils import tokenizer_image_token


@dataclass
class PreprocessArgs:
    """Subset of DataArguments consumed here (data_classes.py:31-60)."""

    is_multimodal: bool = True
    num_frames: int = 32
    num_slow_frames: int = 8
    mm_use_im_start_end: bool = False
    mm_use_sf_vid_separator_token: bool = False
    conv_template: str = "llava_llama_3"


def preprocess_multimodal(sources: Sequence, data_args: PreprocessArgs):
    """Expand <video> -> <image>*num_slow + [sep] + <image>*num_fast."""
    if not data_args.is_multimodal:
        return sources
    for source in sources:
        for sentence in source:
            if DEFAULT_IMAGE_TOKEN in sentence["value"]:
                sentence["value"] = sentence["value"].replace(
                    DEFAULT_IMAGE_TOKEN, "").strip()
                sentence["value"] = (DEFAULT_IMAGE_TOKEN + "\n"
                                     + sentence["value"]).strip()
                replace_token = DEFAULT_IMAGE_TOKEN
                if data_args.mm_use_im_start_end:
                    replace_token = (DEFAULT_IM_START_TOKEN + replace_token
                                     + DEFAULT_IM_END_TOKEN)
                sentence["value"] = sentence["value"].replace(
                    DEFAULT_IMAGE_TOKEN, replace_token)
            if DEFAULT_VIDEO_TOKEN in sentence["value"]:
                assert sentence["value"].count(DEFAULT_VIDEO_TOKEN) == 1
                if data_args.num_slow_frames == data_args.num_frames:
                    num_slow, num_fast, sep = data_args.num_frames, 0, ""
                else:
                    num_slow = data_args.num_slow_frames
                    num_fast = data_args.num_frames
                    sep = (SLOW_FAST_SEPARATOR_TOKEN
                           if data_args.mm_use_sf_vid_separator_token else "")
                vid_replace = (DEFAULT_IMAGE_TOKEN * num_slow + sep
                               + DEFAULT_IMAGE_TOKEN * num_fast)
                sentence["value"] = sentence["value"].replace(
                    DEFAULT_VIDEO_TOKEN, vid_replace)
    return sources


def _build_conversations(sources, conv):
    roles = {"human": conv.roles[0], "gpt": conv.roles[1]}
    conversations = []
    for i, source in enumerate(sources):
        if roles[source[0]["from"]] != conv.roles[0]:
            source = source[1:]
        c = conv.copy()
        c.messages = []
        for j, sentence in enumerate(source):
            role = roles[sentence["from"]]
            assert role == c.roles[j % 2], f"{i}"
            c.append_message(role, sentence["value"])
        conversations.append(c.get_prompt())
    return conversations


def _tokenize(prompt, tokenizer, has_image):
    if has_image:
        return tokenizer_image_token(prompt, tokenizer)
    return tokenizer(prompt).input_ids


def preprocess_llama3(sources, tokenizer, has_image: bool = False,
                      conv=None) -> Dict:
    conv = conv or conversation_lib.conv_templates["llava_llama_3"]
    conversations = _build_conversations(sources, conv)
    input_ids = [np.asarray(_tokenize(c, tokenizer, has_image), np.int64)
                 for c in conversations]
    targets = [ids.copy() for ids in input_ids]
    assert conv.sep_style == conversation_lib.SeparatorStyle.MPT

    sep = conv.sep + conv.roles[1]
    for conversation, target in zip(conversations, targets):
        total_len = int(np.sum(target != tokenizer.pad_token_id))
        rounds = conversation.split(conv.sep)
        re_rounds = [conv.sep.join(rounds[:3])]
        for idx in range(3, len(rounds), 2):
            re_rounds.append(conv.sep.join(rounds[idx:idx + 2]))
        cur_len = 0
        for i, rou in enumerate(re_rounds):
            if rou == "":
                break
            parts = rou.split(sep)
            if len(parts) != 2:
                break
            parts[0] += sep
            round_len = len(_tokenize(rou, tokenizer, has_image)) + 1
            instruction_len = len(_tokenize(parts[0], tokenizer, has_image))
            if i > 0:
                round_len -= 1
                instruction_len -= 1
            target[cur_len: cur_len + instruction_len] = IGNORE_INDEX
            cur_len += round_len
        target[cur_len:] = IGNORE_INDEX
        if cur_len < tokenizer.model_max_length and cur_len != total_len:
            target[:] = IGNORE_INDEX
            print(f"WARNING: tokenization mismatch: {cur_len} vs. "
                  f"{total_len}. (ignored)")
    return {"input_ids": input_ids, "labels": targets}


def preprocess_v1(sources, tokenizer, has_image: bool = False,
                  conv=None) -> Dict:
    conv = conv or conversation_lib.conv_templates["vicuna_v1"]
    conversations = _build_conversations(sources, conv)
    input_ids = [np.asarray(_tokenize(c, tokenizer, has_image), np.int64)
                 for c in conversations]
    targets = [ids.copy() for ids in input_ids]
    assert conv.sep_style == conversation_lib.SeparatorStyle.TWO

    sep = conv.sep + conv.roles[1] + ": "
    for conversation, target in zip(conversations, targets):
        total_len = int(np.sum(target != tokenizer.pad_token_id))
        rounds = conversation.split(conv.sep2)
        cur_len = 1
        target[:cur_len] = IGNORE_INDEX
        for i, rou in enumerate(rounds):
            if rou == "":
                break
            parts = rou.split(sep)
            if len(parts) != 2:
                break
            parts[0] += sep
            round_len = len(_tokenize(rou, tokenizer, has_image))
            instruction_len = len(_tokenize(parts[0], tokenizer,
                                            has_image)) - 2
            if i != 0 and not getattr(tokenizer, "legacy", True):
                round_len -= 1
                instruction_len -= 1
            target[cur_len: cur_len + instruction_len] = IGNORE_INDEX
            cur_len += round_len
        target[cur_len:] = IGNORE_INDEX
        if cur_len < tokenizer.model_max_length and cur_len != total_len:
            target[:] = IGNORE_INDEX
            print(f"WARNING: tokenization mismatch: {cur_len} vs. "
                  f"{total_len}. (ignored)")
    return {"input_ids": input_ids, "labels": targets}


#: the reference gates an mpt masking offset on tokenizers >= 0.14; the
#: port's tokenizer follows the library's current behaviour
TOKENIZERS_GTE_0_14 = True


def preprocess_llama_2(sources, tokenizer, has_image: bool = False,
                       conv=None) -> Dict:
    """Llama-2 [INST] template masking (reference preprocess.py:129-210)."""
    conv = conv or conversation_lib.conv_templates["llava_llama_2"]
    conversations = _build_conversations(sources, conv)
    input_ids = [np.asarray(_tokenize(c, tokenizer, has_image), np.int64)
                 for c in conversations]
    targets = [ids.copy() for ids in input_ids]
    assert conv.sep_style == conversation_lib.SeparatorStyle.LLAMA_2

    sep = "[/INST] "
    for conversation, target in zip(conversations, targets):
        total_len = int(np.sum(target != tokenizer.pad_token_id))
        rounds = conversation.split(conv.sep2)
        cur_len = 1
        target[:cur_len] = IGNORE_INDEX
        for rou in rounds:
            if rou == "":
                break
            parts = rou.split(sep)
            if len(parts) != 2:
                break
            parts[0] += sep
            round_len = len(_tokenize(rou, tokenizer, has_image))
            instruction_len = len(_tokenize(parts[0], tokenizer,
                                            has_image)) - 2
            target[cur_len: cur_len + instruction_len] = IGNORE_INDEX
            cur_len += round_len
        target[cur_len:] = IGNORE_INDEX
        if cur_len < tokenizer.model_max_length and cur_len != total_len:
            target[:] = IGNORE_INDEX
            print(f"WARNING: tokenization mismatch: {cur_len} vs. "
                  f"{total_len}. (ignored)")
    return {"input_ids": input_ids, "labels": targets}


def preprocess_mpt(sources, tokenizer, has_image: bool = False,
                   conv=None) -> Dict:
    """MPT <|im_end|> template masking (reference preprocess.py:391-479)."""
    conv = conv or conversation_lib.conv_templates["mpt"]
    conversations = _build_conversations(sources, conv)
    input_ids = [np.asarray(_tokenize(c, tokenizer, has_image), np.int64)
                 for c in conversations]
    targets = [ids.copy() for ids in input_ids]
    assert conv.sep_style == conversation_lib.SeparatorStyle.MPT

    sep = conv.sep + conv.roles[1]
    for conversation, target in zip(conversations, targets):
        total_len = int(np.sum(target != tokenizer.pad_token_id))
        rounds = conversation.split(conv.sep)
        re_rounds = [conv.sep.join(rounds[:3])]  # system + user + gpt
        for idx in range(3, len(rounds), 2):
            re_rounds.append(conv.sep.join(rounds[idx:idx + 2]))
        cur_len = 0
        for i, rou in enumerate(re_rounds):
            if rou == "":
                break
            parts = rou.split(sep)
            if len(parts) != 2:
                break
            parts[0] += sep
            round_len = len(_tokenize(rou, tokenizer, has_image))
            instruction_len = len(_tokenize(parts[0], tokenizer,
                                            has_image)) - 1
            if (i != 0 and getattr(tokenizer, "legacy", False)
                    and TOKENIZERS_GTE_0_14):
                round_len += 1
                instruction_len += 1
            target[cur_len: cur_len + instruction_len] = IGNORE_INDEX
            cur_len += round_len
        target[cur_len:] = IGNORE_INDEX
        if cur_len < tokenizer.model_max_length and cur_len != total_len:
            target[:] = IGNORE_INDEX
            print(f"WARNING: tokenization mismatch: {cur_len} vs. "
                  f"{total_len}. (ignored)")
    return {"input_ids": input_ids, "labels": targets}


def preprocess_plain(sources, tokenizer, conv=None) -> Dict:
    conv = conv or conversation_lib.conv_templates["plain"]
    conversations = []
    for source in sources:
        assert len(source) == 2
        assert DEFAULT_IMAGE_TOKEN in source[0]["value"]
        if VIDEO_SEG_TOKEN in source[1]["value"]:
            raise ValueError(
                "Referral type prompt is not compatible with 'plain' "
                "preprocessing")
        num_frames = source[0]["value"].count(DEFAULT_IMAGE_TOKEN)
        source[0]["value"] = DEFAULT_IMAGE_TOKEN * num_frames
        conversations.append(source[0]["value"] + source[1]["value"]
                             + conv.sep)
    input_ids = [np.asarray(tokenizer_image_token(p, tokenizer), np.int64)
                 for p in conversations]
    targets = [ids.copy() for ids in input_ids]
    for target, source in zip(targets, sources):
        tokenized_len = len(tokenizer_image_token(source[0]["value"],
                                                  tokenizer))
        target[:tokenized_len] = IGNORE_INDEX
    return {"input_ids": input_ids, "labels": targets}


def preprocess(sources, tokenizer, has_image: bool = False,
               template: str = "llava_llama_3") -> Dict:
    conv = conversation_lib.conv_templates[template]
    # Dispatch order mirrors reference preprocess.py:512-533:
    # PLAIN -> LLAMA_2 -> v1 -> mpt -> llama3.
    if conv.sep_style == conversation_lib.SeparatorStyle.PLAIN:
        return preprocess_plain(sources, tokenizer, conv)
    if conv.sep_style == conversation_lib.SeparatorStyle.LLAMA_2:
        return preprocess_llama_2(sources, tokenizer, has_image, conv)
    if conv.version.startswith("v1"):
        return preprocess_v1(sources, tokenizer, has_image, conv)
    if conv.version == "mpt":
        return preprocess_mpt(sources, tokenizer, has_image, conv)
    if conv.version == "llama3":
        return preprocess_llama3(sources, tokenizer, has_image, conv)
    raise NotImplementedError(f"template {template} not supported")
