"""Edit-instruction parsing and CoT prompt construction (a copy of
`videocof_tpu/data/instructions.py`).

Behavioural spec: reference `derive_ground_object_from_instruction`
(`videox_fun/data/dataset_image_video.py:260-297`) and the training prompt
template (`dataset_image_video.py:1181`, `fast_infer.py:402-407`): the
grounding phrase names *what* the edit localizes, and the final prompt narrates
the see -> reason -> edit frame sequence.
"""

from __future__ import annotations

import re


def derive_ground_object_from_instruction(instruction: str) -> str:
    s = (instruction or "").strip()
    if not s:
        return "the target area"
    s = s.rstrip(".").strip()

    # swap/replace: the phrase between replace/swap and with/by
    for pat in (r"\breplace\s+(.*?)\s+(?:with|by)\b",
                r"\bswap\s+(.*?)\s+with\b"):
        m = re.search(pat, s, flags=re.IGNORECASE)
        if m:
            phrase = m.group(1).strip(" .,:;")
            if phrase:
                return phrase

    # removal: object after remove/delete/erase/eliminate up to a
    # preposition or punctuation
    m = re.search(
        r"\b(?:remove|delete|erase|eliminate)\s+(.*?)"
        r"(?:\s+(?:from|in|at|on|over|under|near|by)\b|[.,;]|$)",
        s, flags=re.IGNORECASE)
    if m:
        phrase = m.group(1).strip(" .,:;")
        if phrase:
            return phrase

    # addition: generic target area
    if re.search(r"^\s*(?:add|insert)\b", s, flags=re.IGNORECASE):
        return "the target area"

    # local style (change/make ...): determiner + first noun
    m = re.search(r"\b(?:change|make)\s+(?:(the|a|an)\s+)?"
                  r"([A-Za-z][A-Za-z0-9\-]*)", s, flags=re.IGNORECASE)
    if m:
        det = m.group(1) or ""
        return (det + " " + m.group(2)).strip()

    return "the target area"


def build_cot_prompt(edit_instruction: str) -> str:
    """The chain-of-frames training/inference prompt (`fast_infer.py:402-407`)."""
    ground = derive_ground_object_from_instruction(edit_instruction)
    return ("A video sequence showing three parts: first the original scene, "
            f"then grounded {ground}, and finally the same scene but "
            f"{edit_instruction}")
