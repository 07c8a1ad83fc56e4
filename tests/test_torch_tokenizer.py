"""The port's tokenizer (`video_llava_seg_torch/tokenizer.py`) against
transformers' fast tokenizer, on tiny tokenizers trained here with the
`tokenizers` library in each family format the repo supports (nothing is
downloaded):

- Llama-3: byte-level BPE, Split(Llama-3 pattern) + ByteLevel(use_regex
  false), ignore_merges, the specials after the base vocabulary, a
  TemplateProcessing BOS;
- SentencePiece style (Llama-2 / Vicuna / Mistral): byte_fallback BPE,
  the spaces by a Metaspace pre-tokenizer (legacy false) or by a
  Prepend + Replace normalizer (legacy true), BOS from add_bos_token;
- MPT (GPT-NeoX): NFC, ByteLevel on the GPT-2 pattern, no BOS.

Ids and decodes must be equal, on a fixed corpus and on hypothesis text.
Python 3.12's `unicodedata` is Unicode 15.0 while the `tokenizers`
library's oniguruma knows Unicode 16.0: the 4,924 letters and 80
numbers assigned since (U+1C89 ... U+2EE5D) are unassigned (category
Cn) to Python, so the hypothesis text draws no Cn code point.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import sys

import numpy as np
import pytest

LLAMA3_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+"
                  r"|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+"
                  r"|\s+(?!\S)|\s+")
LLAMA3_SPECIALS = ["<|begin_of_text|>", "<|end_of_text|>",
                   "<|reserved_special_token_0|>",
                   "<|reserved_special_token_1|>",
                   "<|finetune_right_pad_id|>",
                   "<|reserved_special_token_2|>", "<|start_header_id|>",
                   "<|end_header_id|>", "<|eom_id|>", "<|eot_id|>",
                   "<|python_tag|>"]

_WORDS = ("the a dog runs across field video scene person man woman car "
          "red blue small large left right moving walking standing holds "
          "describe segmentation mask object background events actors "
          "quickly slowly while then first second number don't it's "
          "we're they've I'm you'll she'd").split()
_EXTRA = ["12345 67 8 2024", "héllo café naïve Ångström", "你好世界 视频",
          "😀🎉 👍🏽", "tabs\tand\r\nnewlines\n\n  spaces   ", "ALL CAPS "
          "Title Case", "x^2 + y_1 = {z}; (a, b) [c] <tag> \"q\" 'r'",
          "user\n\nassistant", "USER: ASSISTANT: [INST] [/INST] </s>"]


def training_corpus(seed: int = 0, n: int = 400):
    rng = np.random.RandomState(seed)
    lines = []
    for _ in range(n):
        k = rng.randint(3, 14)
        words = [_WORDS[i] for i in rng.randint(0, len(_WORDS), k)]
        if rng.rand() < 0.3:
            words[rng.randint(k)] = str(rng.randint(0, 100000))
        sep = rng.choice([" ", " ", " ", ", ", ". ", "\n"])
        lines.append(sep.join(words).capitalize() + rng.choice(
            [".", "?", "!", ""]))
    return lines + _EXTRA * 5


def _save(tok, config, path):
    os.makedirs(path, exist_ok=True)
    tok.save(osp.join(path, "tokenizer.json"))
    with open(osp.join(path, "tokenizer_config.json"), "w") as fh:
        json.dump(config, fh)
    return path


def write_llama3(path, vocab_size: int = 700, seed: int = 0):
    """A Llama-3-format tokenizer: base vocab, then the specials."""
    from tokenizers import (Regex, Tokenizer, decoders, models,
                            pre_tokenizers, processors, trainers)

    tok = Tokenizer(models.BPE(ignore_merges=True))
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(LLAMA3_PATTERN), behavior="isolated",
                             invert=False),
        pre_tokenizers.ByteLevel(add_prefix_space=False, trim_offsets=True,
                                 use_regex=False)])
    tok.decoder = decoders.ByteLevel(add_prefix_space=True,
                                     trim_offsets=True, use_regex=True)
    tok.train_from_iterator(training_corpus(seed), trainers.BpeTrainer(
        vocab_size=vocab_size, show_progress=False,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    tok.add_special_tokens(LLAMA3_SPECIALS)
    bos = tok.token_to_id("<|begin_of_text|>")
    tok.post_processor = processors.Sequence([
        processors.ByteLevel(trim_offsets=False),
        processors.TemplateProcessing(
            single="<|begin_of_text|> $A",
            pair="<|begin_of_text|> $A <|begin_of_text|> $B:1",
            special_tokens=[("<|begin_of_text|>", bos)])])
    return _save(tok, {"bos_token": "<|begin_of_text|>",
                       "eos_token": "<|eot_id|>",
                       "clean_up_tokenization_spaces": True,
                       "model_max_length": 1000000,
                       "tokenizer_class": "PreTrainedTokenizerFast"}, path)


def write_sentencepiece(path, legacy: bool, vocab_size: int = 400,
                        seed: int = 0):
    """A Llama-2 / Mistral-format tokenizer: <unk> <s> </s>, byte_fallback
    with the 256 <0xNN> pieces in the vocab; legacy true: Prepend +
    Replace normalizer (Mistral, Vicuna), false: Metaspace("first")."""
    from tokenizers import (Tokenizer, decoders, models, normalizers,
                            pre_tokenizers, processors, trainers)

    tok = Tokenizer(models.BPE(unk_token="<unk>", byte_fallback=True,
                               fuse_unk=True))
    tok.normalizer = normalizers.Replace(" ", "▁")
    tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁",
                                                 prepend_scheme="always")
    tok.train_from_iterator(training_corpus(seed), trainers.BpeTrainer(
        vocab_size=vocab_size, show_progress=False, limit_alphabet=120,
        special_tokens=["<unk>", "<s>", "</s>"]))
    spec = json.loads(tok.to_str())
    vocab = spec["model"]["vocab"]
    for b in range(256):
        vocab.setdefault(f"<0x{b:02X}>", len(vocab))
    if legacy:
        spec["normalizer"] = {"type": "Sequence", "normalizers": [
            {"type": "Prepend", "prepend": "▁"},
            {"type": "Replace", "pattern": {"String": " "},
             "content": "▁"}]}
        spec["pre_tokenizer"] = None
    else:
        spec["normalizer"] = None
        spec["pre_tokenizer"] = {"type": "Metaspace", "replacement": "▁",
                                 "prepend_scheme": "first", "split": False}
    tok = Tokenizer.from_str(json.dumps(spec))
    tok.decoder = decoders.Sequence([
        decoders.Replace("▁", " "), decoders.ByteFallback(),
        decoders.Fuse(), decoders.Strip(" ", 1, 0)])
    tok.post_processor = processors.TemplateProcessing(
        single="<s> $A", pair="<s> $A <s> $B",
        special_tokens=[("<s>", tok.token_to_id("<s>"))])
    return _save(tok, {"bos_token": "<s>", "eos_token": "</s>",
                       "unk_token": "<unk>", "pad_token": None,
                       "add_bos_token": True, "add_eos_token": False,
                       "legacy": legacy, "model_max_length": 4096,
                       "clean_up_tokenization_spaces": False,
                       "tokenizer_class": "LlamaTokenizerFast"}, path)


def write_mpt(path, vocab_size: int = 600, seed: int = 0):
    """An MPT / GPT-NeoX-format tokenizer: NFC, ByteLevel with the GPT-2
    pattern, <|endoftext|> / <|padding|> at 0 / 1, the chat specials."""
    from tokenizers import (Tokenizer, decoders, models, normalizers,
                            pre_tokenizers, processors, trainers)

    tok = Tokenizer(models.BPE())
    tok.normalizer = normalizers.NFC()
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False,
                                                 use_regex=True)
    tok.decoder = decoders.ByteLevel()
    tok.post_processor = processors.ByteLevel(trim_offsets=True)
    tok.train_from_iterator(training_corpus(seed), trainers.BpeTrainer(
        vocab_size=vocab_size, show_progress=False,
        special_tokens=["<|endoftext|>", "<|padding|>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    tok.add_special_tokens(["<|im_start|>", "<|im_end|>"])
    return _save(tok, {"bos_token": "<|endoftext|>",
                       "eos_token": "<|endoftext|>",
                       "unk_token": "<|endoftext|>",
                       "add_bos_token": False, "add_eos_token": False,
                       "model_max_length": 2048,
                       "clean_up_tokenization_spaces": True,
                       "tokenizer_class": "GPTNeoXTokenizerFast"}, path)


FAMILIES = {"llama3": write_llama3,
            "sp_metaspace": lambda p: write_sentencepiece(p, legacy=False),
            "sp_prepend": lambda p: write_sentencepiece(p, legacy=True),
            "mpt": write_mpt}


@pytest.fixture(scope="module")
def tokenizer_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tokenizers")
    return {name: fn(str(root / name)) for name, fn in FAMILIES.items()}


def _pair(path):
    from transformers import AutoTokenizer

    from video_llava_seg_torch.tokenizer import Tokenizer

    return AutoTokenizer.from_pretrained(path), Tokenizer.from_pretrained(path)


@pytest.fixture(scope="module")
def pairs(tokenizer_dirs):
    return {name: _pair(path) for name, path in tokenizer_dirs.items()}


def fixed_corpus():
    """Every template's rendered prompt, the <image> splits, specials,
    digit and whitespace runs, \\r\\n, CJK, accents and emoji."""
    from video_llava_seg_torch import conversation as conv_lib

    texts = []
    for name, conv in conv_lib.conv_templates.items():
        if conv.sep_style.name == "PLAIN":  # preprocess_plain: no prompt
            continue
        c = conv.copy()
        c.messages = []
        c.append_message(c.roles[0], "<image>\nDescribe the video in "
                                     "detail. <vid_seg> please")
        c.append_message(c.roles[1], "A man walks a dog.</s> It's 2024!")
        c.append_message(c.roles[0], "And then?")
        c.append_message(c.roles[1], None)
        prompt = c.get_prompt()
        texts.append(prompt)
        texts.extend(prompt.split("<image>"))
    texts += [
        "", " ", "  ", "\n", "\r\n", "a\r\nb", "  leading", "trailing   ",
        "word  \n  word", "tab\t\tsep", "1", "12", "123", "1234",
        "1234567890123", "3.14159 -42 +7e10", "don't DON'T it'S we'll",
        "<|begin_of_text|><|start_header_id|>user<|end_header_id|>\n\nhi"
        "<|eot_id|>", "<s>[INST] x [/INST] y </s><s>", "<|im_start|>user\n"
        "hi<|im_end|>", "<|endoftext|>tail", "<unk> <0x41>", "你好，世界！",
        "日本語のテキスト", "한국어", "Ελληνικά κείμενα", "Ünïcödé àccents",
        "é combining", "😀", "👨‍👩‍👧 family", "🇫🇷 flag", "　ideo nbsp",
        "\x1c\x1d\x1e\x1f", "\x00\x01 ctrl", "a b c",
        "<vid_seg><vid_seg>", "x<vid_seg> y", "<sf_vid_separator>",
        "mixed 中文 and English 123 😀!!", "   ...   ???",
    ]
    return texts


@pytest.mark.parametrize("family", list(FAMILIES))
def test_ids_equal_on_the_fixed_corpus(pairs, family):
    hf, port = pairs[family]
    for text in fixed_corpus():
        assert port(text).input_ids == hf(text).input_ids, repr(text)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_image_token_splits_equal(pairs, family):
    from video_llava_seg_torch.inference import main as serve
    from video_llava_seg_torch.config import VideoLlavaConfig
    from video_llava_seg_torch.mm_utils import tokenizer_image_token

    hf, port = pairs[family]
    cfg = VideoLlavaConfig.tiny()
    for tmpl in ("llava_llama_3", "v1", "llava_llama_2", "mpt",
                 "mistral_instruct", "plain"):
        prompt = serve.build_prompt(cfg, serve.CAPTION_PROMPT, tmpl)
        assert tokenizer_image_token(prompt, port) == \
            tokenizer_image_token(prompt, hf), tmpl


@pytest.mark.parametrize("family", list(FAMILIES))
def test_decode_equal(pairs, family):
    hf, port = pairs[family]
    rng = np.random.RandomState(3)
    n = len(hf)
    seqs = [hf(t).input_ids for t in fixed_corpus()]
    seqs += [rng.randint(0, n, 12).tolist() for _ in range(40)]
    for ids in seqs:
        for skip in (True, False):
            assert port.decode(ids, skip_special_tokens=skip) == \
                hf.decode(ids, skip_special_tokens=skip), (ids, skip)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_attributes_and_added_tokens(tokenizer_dirs, family):
    hf, port = _pair(tokenizer_dirs[family])
    for name in ("bos_token_id", "eos_token_id", "pad_token_id",
                 "unk_token_id", "model_max_length"):
        assert getattr(port, name) == getattr(hf, name), name
    assert getattr(port, "legacy", "absent") == \
        getattr(hf, "legacy", "absent")
    assert len(port) == len(hf)
    new = ["<sf_vid_separator>", "<vid_seg>"]
    assert port.add_tokens(new, special_tokens=True) == \
        hf.add_tokens(new, special_tokens=True)
    assert port.add_tokens(["<vid_seg>", "plain_added"]) == \
        hf.add_tokens(["<vid_seg>", "plain_added"])
    assert len(port) == len(hf)
    for tok in new + ["plain_added", "<|eot_id|>", "</s>", "never-seen",
                      "the"]:
        assert port.convert_tokens_to_ids(tok) == \
            hf.convert_tokens_to_ids(tok), tok
    for text in ("a<vid_seg><vid_seg> b<sf_vid_separator>c",
                 "xplain_added y", " <vid_seg> "):
        ids = hf(text).input_ids
        assert port(text).input_ids == ids, text
        for skip in (True, False):
            assert port.decode(ids, skip_special_tokens=skip) == \
                hf.decode(ids, skip_special_tokens=skip)


def test_hypothesis_text(pairs):
    hypothesis = pytest.importorskip("hypothesis")
    from hypothesis import strategies as st

    alphabet = st.characters(blacklist_categories=("Cs", "Cn"))
    words = st.sampled_from(["<|eot_id|>", "</s>", "<s>", "<|im_end|>",
                             " ", "\n", "\r\n", "  ", "'s", "123", "▁"])
    text = st.lists(st.one_of(st.text(alphabet, max_size=12), words),
                    max_size=8).map("".join)

    @hypothesis.settings(max_examples=200, deadline=None, derandomize=True,
                         suppress_health_check=list(
                             hypothesis.HealthCheck))
    @hypothesis.given(text)
    def check(t):
        for family, (hf, port) in pairs.items():
            ids = hf(t).input_ids
            assert port(t).input_ids == ids, (family, t)
            assert port.decode(ids) == hf.decode(ids), (family, t)

    check()


def test_chip_smoke_llama3_writer_matches_transformers(tmp_path):
    """chip_smoke.py writes its Llama-3-format tokenizer.json without the
    `tokenizers` library (the card's machine has none): transformers
    reads it to the same ids and decodes as the port, the specials from
    128000, and the two vision tokens land on 128254 / 128255, inside
    Llama-3-8B's 128256 embeddings."""
    import chip_smoke

    path = chip_smoke.write_llama3_tokenizer(
        str(tmp_path / "llama3"), chip_smoke.tokenizer_corpus(),
        n_merges=120)
    hf, port = _pair(path)
    assert port.convert_tokens_to_ids("<|begin_of_text|>") == 128000
    for text in fixed_corpus() + chip_smoke.tokenizer_corpus():
        ids = hf(text).input_ids
        assert port(text).input_ids == ids, repr(text)
        assert port.decode(ids) == hf.decode(ids)
    new = ["<sf_vid_separator>", "<vid_seg>"]
    assert port.add_tokens(new, special_tokens=True) == \
        hf.add_tokens(new, special_tokens=True) == 2
    assert port.convert_tokens_to_ids(new) == \
        hf.convert_tokens_to_ids(new) == [128254, 128255]


def test_imports_no_tokenizer_library():
    """tokenizer.py imports none of transformers, tokenizers or regex."""
    import subprocess

    code = ("import sys\n"
            "class Block:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name.split('.')[0] in ('transformers', 'tokenizers',"
            " 'regex', 'jax', 'video_llava_seg_tpu'):\n"
            "            raise ImportError('blocked: ' + name)\n"
            "sys.meta_path.insert(0, Block())\n"
            "import video_llava_seg_torch.tokenizer as t\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('transformers', 'tokenizers', 'regex')))\n")
    root = osp.dirname(osp.dirname(osp.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_refusals(tmp_path):
    from video_llava_seg_torch.tokenizer import Tokenizer

    sp_only = tmp_path / "vicuna"
    sp_only.mkdir()
    (sp_only / "tokenizer.model").write_bytes(b"\x0a\x00")
    with pytest.raises(OSError, match="tokenizer.json"):
        Tokenizer.from_pretrained(str(sp_only))
    with pytest.raises(OSError, match="not a local directory"):
        Tokenizer.from_pretrained("meta-llama/Meta-Llama-3-8B-Instruct")
    with pytest.raises(FileNotFoundError):
        Tokenizer.from_pretrained(str(tmp_path))
