"""Math word-problem answer scoring (MWPBench protocol).

Capability-equivalent of mathscale/MWPBench/eval_vllm/util.py: extract a
short answer from a model completion (\\boxed{} with balanced braces, else
the last number when the reference is numeric, else the ``answer is ...``
tail), normalize both sides through the LaTeX canonicalizer, and judge
equivalence (numeric compare, inline-math containment, substring for long
symbolic answers). The evaluation protocol (per-task accuracy over a
unified jsonl of {question, answer, data_topic}) follows eval_vllm's
evaluation loop.

Reimplemented from the observed behavior; structure is our own (a table of
regex rewrites + small passes instead of one 100-line function).

The port's copy of unilm_tpu/scoring_math.py
(pure Python: the port imports nothing of the JAX package), held
against it by the CPU tests.
"""

from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

# --------------------------------------------------------------------------- #
# \boxed extraction (balanced braces — re cannot do this part)
# --------------------------------------------------------------------------- #


def extract_boxed(text: str) -> List[str]:
    """All \\boxed{...} / \\fbox{...} contents, balanced-brace aware
    (util.py:120-136 unbox_and_extract)."""
    out = []
    for m in re.finditer(r"\\(?:boxed|fbox)\{", text):
        depth, start = 1, m.end()
        for i in range(start, len(text)):
            if text[i] == "{":
                depth += 1
            elif text[i] == "}":
                depth -= 1
                if depth == 0:
                    out.append(text[start:i])
                    break
    return out


# --------------------------------------------------------------------------- #
# LaTeX answer canonicalization
# --------------------------------------------------------------------------- #

_REWRITES = (
    (",", ""), ("\n", ""), ("\\!", ""), ("\\\\", "\\"),
    ("tfrac", "frac"), ("dfrac", "frac"),
    ("\\left", ""), ("\\right", ""),
    ("^{\\circ}", ""), ("^\\circ", ""),
    ("\\$", ""), ("\\%", ""), ("%", ""),
    (" .", " 0."), ("{.", "{0."),
    ("\\quad", " "),
)


def _brace_fracs(s: str) -> str:
    """\\frac1b -> \\frac{1}{b}; \\frac1{72} -> \\frac{1}{72}
    (util.py fix_fracs)."""
    s = re.sub(r"\\frac([^{\s])([^{\s])", r"\\frac{\1}{\2}", s)
    s = re.sub(r"\\frac([^{\s])\{", r"\\frac{\1}{", s)
    return s


def normalize_math_answer(s: str) -> str:
    """Canonical form used on BOTH sides of the comparison
    (util.py:153-232 strip_string)."""
    # ((3)/(4)) -> \frac{3}{4}
    s = re.sub(r"\(\((\d+)\)/\((\d+)\)\)", r"\\frac{\1}{\2}", s)
    for a, b in _REWRITES:
        s = s.replace(a, b)
    # units written as \text{ ...} on the right
    if "\\text{ " in s:
        s = s.split("\\text{ ")[0]
    if s.startswith("."):
        s = "0" + s
    # drop a short leading "k = "
    parts = s.split("=")
    if len(parts) == 2 and len(parts[0]) <= 2:
        s = parts[1]
    s = re.sub(r"\\sqrt([^{\s])", r"\\sqrt{\1}", s)
    s = s.replace(" ", "")
    s = _brace_fracs(s)
    if s == "0.5":
        s = "\\frac{1}{2}"
    m = re.fullmatch(r"(-?\d+)/(-?\d+)", s)
    if m:
        s = f"\\frac{{{m.group(1)}}}{{{m.group(2)}}}"
    return s


def _is_number(s: str) -> bool:
    try:
        float(s.strip("$"))
        return True
    except ValueError:
        return False


# --------------------------------------------------------------------------- #
# Extraction + equivalence
# --------------------------------------------------------------------------- #

_NUM = re.compile(r"[-+]?\d*[\.,/]?\d+")


def extract_answer(completion: str, reference_is_number: bool) -> Optional[str]:
    """Short-answer extraction ladder (util.py is_correct:283-330):
    last \\boxed -> last number (numeric refs) -> 'answer/solution is' tail."""
    boxed = extract_boxed(completion)
    if boxed:
        return boxed[-1].strip()
    if reference_is_number:
        nums = _NUM.findall(completion)
        return nums[-1] if nums else None
    for key in ("answer is", "solution is"):
        if key in completion:
            tail = completion.split(key)[-1].strip().lstrip(":").strip()
            tail = tail.split(".\n")[0].strip().rstrip(".").strip()
            return tail or None
    m = list(re.finditer(r"\bis\b", completion))
    if m:
        tail = completion[m[-1].end():].strip().rstrip(".").strip()
        return tail or None
    return None


def answers_equiv(prediction: Optional[str], reference: Optional[str]) -> bool:
    """Judge ladder (util.py is_equiv:249-280): numeric equality ->
    inline-math containment -> long-symbolic substring -> exact match."""
    if prediction is None or reference is None:
        return prediction is None and reference is None
    p, r = normalize_math_answer(prediction), normalize_math_answer(reference)
    if _is_number(p) and _is_number(r):
        return float(p.strip("$")) == float(r.strip("$"))
    if re.fullmatch(r"\$[^$]+\$", r):
        return r.strip("$") in p.strip("$")
    for a, b in ((p, r), (r, p)):
        if (len(a) >= 3 and not _is_number(a)
                and not a.startswith("-") and not b.startswith("-")
                and a in b):
            return True
    return p == r


def math_is_correct(completion: str, answer: str) -> Tuple[bool, Optional[str], str]:
    """(judge, extracted_prediction, normalized_reference) — lowercases both
    sides first like util.py:284-285."""
    completion, answer = completion.lower(), answer.lower()
    ref_norm = normalize_math_answer(answer)
    pred = extract_answer(completion, _is_number(ref_norm))
    return answers_equiv(pred, answer), pred, ref_norm


def mwpbench_eval(
    records: Sequence[Dict], completions: Sequence[str]
) -> Dict:
    """Per-topic + micro/macro accuracy over MWPBench-format records
    ({question, answer, data_topic}), as eval_vllm's main()."""
    per: Dict[str, List[bool]] = defaultdict(list)
    rows = []
    for rec, comp in zip(records, completions):
        ok, pred, ref = math_is_correct(comp, rec["answer"])
        per[rec.get("data_topic", "all")].append(ok)
        rows.append({"question": rec["question"], "judge": ok,
                     "clean_prediction_ans": pred, "clean_reference_ans": ref})
    tasks = {t: {"accuracy": sum(v) / len(v), "test_size": len(v)}
             for t, v in sorted(per.items())}
    n = sum(len(v) for v in per.values())
    return {
        "tasks": tasks,
        "micro_accuracy": sum(sum(v) for v in per.values()) / max(n, 1),
        "macro_accuracy": (sum(t["accuracy"] for t in tasks.values())
                           / max(len(tasks), 1)),
        "rows": rows,
    }


# Prompt templates (eval_vllm's TEMPLATE_DICT)
PROMPT_TEMPLATES = {
    "none": "{instruction}",
    "alpaca": (
        "Below is an instruction that describes a task. "
        "Write a response that appropriately completes the request.\n\n"
        "### Instruction:\n{instruction}\n\n### Response:"
    ),
    "alpaca_force_ans": (
        "Below is an instruction that describes a task. "
        "Write a response that appropriately completes the request.\n\n"
        "### Instruction:\n{instruction}\n\n"
        "Try to conclude your response with 'The answer is ...'.\n### Response:"
    ),
    "alpaca_cot": (
        "Below is an instruction that describes a task. "
        "Write a response that appropriately completes the request.\n\n"
        "### Instruction:\n{instruction}\n\n### Response: "
        "Let's think step by step."
    ),
}
