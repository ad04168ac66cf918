"""Arabic verb-form generator (corpus synthesis with ground-truth roots).

The paper validates against the Holy Quran text; that corpus is not shipped
here, so we synthesise a corpus by *generating* verb forms from known roots
using the morphological patterns of the paper's Tables 1-2:

  - past / present / future tense affixes (person + number + gender),
  - proclitics (و ف + interrogative أ + future س),
  - object-pronoun enclitics (ه ها هم كم نا ني ..),
  - form III (فاعل — the ا infix the Remove-Infix pass targets),
  - form X (استفعل — the است prefix of أفاستسقيناكموها),
  - hollow-verb conversion (middle و/ي → ا in the past: قول → قال),
  - defective-verb final-vowel alternation (سقي → سقى / يسقو).

Every generated surface form carries its ground-truth root, enabling exact
accuracy measurement (Table 6/7 analogue).
"""
from __future__ import annotations

import itertools

WAW, YEH, ALEF = "و", "ي", "ا"

PAST_SUFFIXES = ["", "ت", "نا", "تم", "تن", "وا", "ا", "تا", "ن"]
PRESENT_PREFIXES = ["ي", "ت", "ن", "ا"]
PRESENT_SUFFIXES = ["", "ون", "ان", "ين", "ن"]
PAST_PROCLITICS = ["", "و", "ف", "ا"]
PRESENT_PROCLITICS = ["", "و", "ف", "س", "وس", "فس", "ا", "اف"]
OBJECT_SUFFIXES = ["", "ه", "ها", "هم", "كم", "ني", "نا", "كموها"]


def _is_hollow(root: str) -> bool:
    return len(root) == 3 and root[1] in (WAW, YEH)


def _is_defective(root: str) -> bool:
    return len(root) == 3 and root[2] in (WAW, YEH, ALEF)


def conjugate(root: str, rich: bool = True) -> list[tuple[str, str]]:
    """All generated (surface_form, tag) pairs for one root.

    Tags record the morphological derivation for analysis:
    past / present / form3 / form10 / hollow_past / ...
    """
    out: list[tuple[str, str]] = []
    tri = len(root) == 3

    past_stems = [(root, "past")]
    present_stems = [(root, "present")]
    if tri and _is_hollow(root):
        past_stems.append((root[0] + ALEF + root[2], "hollow_past"))
        # 1st/2nd person past drops the middle radical entirely: قلت, كنت
        past_stems.append((root[0] + root[2], "hollow_short_past"))
    if tri and _is_defective(root):
        past_stems.append((root[:2] + "ى", "defective_past"))
    if tri and rich:
        past_stems.append((root[0] + ALEF + root[1] + root[2], "form3"))
        past_stems.append(("است" + root, "form10"))
        present_stems.append((root[0] + ALEF + root[1] + root[2], "form3_present"))
        present_stems.append(("ست" + root, "form10_present"))

    for (stem, tag), proc, suf in itertools.product(
        past_stems, PAST_PROCLITICS, PAST_SUFFIXES
    ):
        if tag == "hollow_short_past" and suf == "":
            continue  # the short stem only ever occurs with a person suffix
        out.append((proc + stem + suf, tag))

    for (stem, tag), proc, pre, suf in itertools.product(
        present_stems, PRESENT_PROCLITICS, PRESENT_PREFIXES, PRESENT_SUFFIXES
    ):
        out.append((proc + pre + stem + suf, tag))

    if rich:
        base = [w for w, t in out if t in ("past", "present")][:24]
        out.extend((w + obj, "object") for w in base for obj in OBJECT_SUFFIXES[1:4])
    return out


def conjugation_table(root: str) -> dict[str, list[str]]:
    """Grouped view (debugging / docs): tag -> forms."""
    table: dict[str, list[str]] = {}
    for w, t in conjugate(root):
        table.setdefault(t, []).append(w)
    return table
