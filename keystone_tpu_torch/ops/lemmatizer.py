"""English inflectional lemmatizer (the CoreNLP-fidelity tier).

Port of ``keystone_tpu/ops/lemmatizer.py``: the same tables and rules, a
copy kept in this package (it imports nothing of the reference). Host
string work, as in the reference.

The reference's CoreNLPFeatureExtractor lemmatizes tokens through Stanford
CoreNLP's finite-state Morpha stemmer (CoreNLPFeatureExtractor.scala:18).
CoreNLP is a JVM dependency that cannot be vendored here, so this module
implements the same *class* of analysis in-tree: inflectional morphology only
(noun number, verb tense/aspect/agreement, adjective comparison), via an
irregular-form exception table plus a Morpha/WordNet-morphy-style detachment
rule cascade with orthographic repair (consonant un-doubling, silent-e
restoration, y/i alternation). Derivational suffixes (-ness, -tion, -ly …)
are deliberately left intact — Morpha does not strip them either.

No POS input: like Morpha's bare mode, rules are tried noun-then-verb.
"""

from __future__ import annotations

from typing import Dict

_VOWELS = set("aeiou")

# Irregular inflected form -> lemma. Verbs (past/participle/3sg), nouns
# (plurals), adjectives (comparative/superlative). Curated for coverage of
# the most frequent English irregulars.
_IRREGULAR: Dict[str, str] = {
    # --- be / auxiliaries
    "am": "be", "is": "be", "are": "be", "was": "be", "were": "be",
    "been": "be", "being": "be",
    "has": "have", "had": "have", "having": "have",
    "does": "do", "did": "do", "done": "do", "doing": "do",
    "cannot": "can", "won't": "will", "n't": "not",
    # --- pasts of -ee verbs (the -eed rule keeps base forms unchanged)
    "agreed": "agree", "freed": "free", "decreed": "decree",
    "guaranteed": "guarantee", "refereed": "referee",
    # --- common irregular verbs (past, participle)
    "went": "go", "gone": "go", "goes": "go",
    "said": "say", "made": "make", "took": "take", "taken": "take",
    "came": "come", "saw": "see", "seen": "see", "got": "get",
    "gotten": "get", "knew": "know", "known": "know",
    "thought": "think", "gave": "give", "given": "give",
    "found": "find", "told": "tell", "became": "become",
    "left": "leave", "felt": "feel", "brought": "bring",
    "began": "begin", "begun": "begin", "kept": "keep", "held": "hold",
    "wrote": "write", "written": "write", "stood": "stand",
    "heard": "hear", "meant": "mean", "met": "meet", "ran": "run",
    "paid": "pay", "sat": "sit", "spoke": "speak", "spoken": "speak",
    "lay": "lie", "lain": "lie", "led": "lead", "grew": "grow",
    "grown": "grow", "lost": "lose", "fell": "fall", "fallen": "fall",
    "sent": "send", "built": "build", "understood": "understand",
    "drew": "draw", "drawn": "draw", "broke": "break", "broken": "break",
    "spent": "spend", "rose": "rise", "risen": "rise", "drove": "drive",
    "driven": "drive", "bought": "buy", "wore": "wear", "worn": "wear",
    "chose": "choose", "chosen": "choose", "ate": "eat", "eaten": "eat",
    "flew": "fly", "flown": "fly", "forgot": "forget",
    "forgotten": "forget", "spoilt": "spoil", "caught": "catch",
    "taught": "teach", "sought": "seek", "fought": "fight",
    "slept": "sleep", "swept": "sweep", "wept": "weep", "crept": "creep",
    "dealt": "deal", "dreamt": "dream", "burnt": "burn",
    "learnt": "learn", "lent": "lend", "bent": "bend", "shot": "shoot",
    "sold": "sell", "threw": "throw", "thrown": "throw", "shook": "shake",
    "shaken": "shake", "hid": "hide", "hidden": "hide", "bit": "bite",
    "bitten": "bite", "beat": "beat", "beaten": "beat",
    "sang": "sing", "sung": "sing", "sank": "sink", "sunk": "sink",
    "swam": "swim", "swum": "swim", "rang": "ring", "rung": "ring",
    "drank": "drink", "drunk": "drink", "sprang": "spring",
    "sprung": "spring", "stole": "steal", "stolen": "steal",
    "froze": "freeze", "frozen": "freeze", "woke": "wake",
    "woken": "wake", "tore": "tear", "torn": "tear", "swore": "swear",
    "sworn": "swear", "bore": "bear", "borne": "bear", "born": "bear",
    "laid": "lay", "slid": "slide", "struck": "strike", "hung": "hang",
    "stuck": "stick", "won": "win", "wound": "wind", "fed": "feed",
    "fled": "flee", "bled": "bleed", "bred": "breed", "sped": "speed",
    "dug": "dig", "spun": "spin", "lit": "light",
    "rode": "ride", "ridden": "ride",
    # --- invariant verbs whose surface looks inflected
    "cut": "cut", "put": "put", "set": "set", "let": "let", "hit": "hit",
    "cost": "cost", "hurt": "hurt", "shut": "shut", "spread": "spread",
    "read": "read",
    # --- irregular noun plurals
    "children": "child", "men": "man", "women": "woman", "feet": "foot",
    "teeth": "tooth", "geese": "goose", "mice": "mouse", "oxen": "ox",
    "people": "person", "lives": "life", "knives": "knife",
    "wives": "wife", "leaves": "leaf", "halves": "half",
    "selves": "self", "shelves": "shelf", "wolves": "wolf",
    "loaves": "loaf", "thieves": "thief", "calves": "calf",
    "scarves": "scarf", "indices": "index", "matrices": "matrix",
    "appendices": "appendix", "vertices": "vertex", "criteria": "criterion",
    "phenomena": "phenomenon", "data": "datum", "media": "medium",
    "analyses": "analysis", "theses": "thesis", "crises": "crisis",
    "hypotheses": "hypothesis", "bases": "basis", "diagnoses": "diagnosis",
    "oases": "oasis", "axes": "axis", "series": "series",
    "species": "species", "cacti": "cactus", "fungi": "fungus",
    "nuclei": "nucleus", "radii": "radius", "stimuli": "stimulus",
    "alumni": "alumnus", "syllabi": "syllabus",
    # --- invariant nouns
    "sheep": "sheep", "deer": "deer", "fish": "fish", "aircraft": "aircraft",
    # --- irregular adjectives
    "better": "good", "best": "good", "worse": "bad", "worst": "bad",
    "further": "far", "farther": "far", "furthest": "far",
    "farthest": "far", "less": "little", "least": "little",
    "more": "much", "most": "much", "elder": "old", "eldest": "old",
    # --- lexical pasts whose stem needs the e the rules can't infer
    "united": "unite", "cited": "cite", "invited": "invite",
    # --- -us nouns whose plural drops -es (vs "uses" -> "use")
    "buses": "bus", "viruses": "virus", "bonuses": "bonus",
    "campuses": "campus", "statuses": "status", "censuses": "census",
    # --- -as/-os singulars' plurals drop -es the same way
    "gases": "gas", "biases": "bias", "aliases": "alias",
    "atlases": "atlas", "canvases": "canvas",
}

# Surface forms that look inflected but are not (Morpha ships the same kind
# of exception list in its verbstem/noun tables): adverbs and nouns in -s,
# -ing nouns/prepositions, -ed-looking words.
_UNINFLECTED = frozenset({
    "always", "perhaps", "lens", "besides", "whereas", "alas", "thus",
    "morning", "evening", "during", "ceiling", "darling", "sibling",
    "something", "anything", "everything", "nothing",
    "hundred", "kindred", "sacred", "naked", "wicked", "rugged",
    "wretched", "beloved",
    # singular nouns in -as/-os/-ics the plural strip must not touch (found
    # by the idempotence property: bias -> "bia")
    "bias", "alias", "atlas", "canvas", "gas", "pancreas",
    "chaos", "cosmos", "ethos", "pathos", "mathematics", "physics",
})

# Words ending in "-ss"/"-us"/"-is" etc. that the -s rules must not touch.
_S_EXCEPTIONS = ("ss", "us", "is", "ous", "news")


def _vowel_groups(w: str) -> int:
    groups, in_group = 0, False
    for ch in w:
        if ch in _VOWELS or ch == "y":
            if not in_group:
                groups += 1
            in_group = True
        else:
            in_group = False
    return groups


def _undouble(stem: str) -> str:
    """stopp -> stop (but keep ll/ss/zz: tell, miss, buzz)."""
    if (
        len(stem) >= 3
        and stem[-1] == stem[-2]
        and stem[-1] not in _VOWELS
        and stem[-1] not in "lszf"
    ):
        return stem[:-1]
    return stem


def _restore_e(stem: str) -> str:
    """mak -> make: restore the silent e for single-syllable C-V-C stems
    (and cv-final stems like 'creat' whose last vowel group is shared)."""
    if len(stem) >= 2 and stem[-1] not in _VOWELS and stem[-1] not in "wxy":
        # Strict C-V-C: exactly one vowel LETTER before the final consonant
        # (vowel digraphs — look, seem, need, rain — take no silent e).
        single_vowel = stem[-2] in _VOWELS and (
            len(stem) < 3 or stem[-3] not in _VOWELS
        )
        if single_vowel and _vowel_groups(stem) == 1:
            return stem + "e"
    if stem.endswith(("at", "iz", "ys")) and _vowel_groups(stem) <= 2:
        return stem + "e"
    # C+"id" stems: decid-, provid-, divid-, resid- -> +e (vowel-"id" stems
    # like raid-/avoid- are real bases and keep their form).
    if (
        len(stem) >= 4
        and stem.endswith("id")
        and stem[-3] not in _VOWELS
    ):
        return stem + "e"
    if len(stem) >= 1 and stem[-1] in "uv":  # argu-, lov-, believ-, continu-
        return stem + "e"
    if len(stem) >= 2 and stem[-1] == "c" and stem[-2] in _VOWELS:
        return stem + "e"  # produc-, notic-
    return stem


def _strip_plural(w: str) -> str:
    if w.endswith("ies") and len(w) > 4:
        return w[:-3] + "y"  # studies -> study
    if w.endswith(("ches", "shes", "sses", "xes", "zes")):
        return w[:-2]  # watches, boxes
    if w.endswith("oes") and len(w) > 4:
        return w[:-2]  # potatoes -> potato (goes handled as irregular)
    if w.endswith("es") and not w.endswith(_S_EXCEPTIONS):
        # Ambiguous -es: "makes" -> "make" (stem keeps its e), "runs" has no
        # es. Try dropping only the "s" first: "makes" -> "make".
        return w[:-1]
    if w.endswith("s") and not w.endswith(_S_EXCEPTIONS) and len(w) > 3:
        return w[:-1]
    return w


def _strip_past(w: str) -> str:
    if w.endswith("ied") and len(w) > 4:
        return w[:-3] + "y"  # studied -> study
    if w.endswith("eed"):
        # Base forms (need, feed, speed, exceed) stay; pasts of -ee verbs
        # (agreed, freed, decreed) are in the irregular table.
        return w
    if w.endswith("ed") and len(w) > 3:
        stem = w[:-2]
        un = _undouble(stem)
        if un != stem:
            return un  # stopped -> stop
        return _restore_e(stem)  # loved: 'lov' -> 'love'; visited -> visit
    return w


def _strip_ing(w: str) -> str:
    if w.endswith("ing") and len(w) > 4:
        stem = w[:-3]
        if not any(c in _VOWELS or c == "y" for c in stem):
            return w  # "ring"-like: no vowel left, not an inflection
        if stem.endswith("y") and len(stem) >= 2:
            return stem  # studying -> study
        un = _undouble(stem)
        if un != stem:
            return un  # running -> run
        return _restore_e(stem)  # making -> make; visiting -> visit
    return w


def lemmatize(word: str) -> str:
    """Best-effort inflectional lemma of a lowercased token."""
    w = word.lower()
    # Irregulars first: "is"/"am" are two-letter words that must still map
    # to "be", so the table outranks the short-word guard.
    if w in _IRREGULAR:
        return _IRREGULAR[w]
    if w in _UNINFLECTED:
        return w
    if len(w) <= 2:
        return w
    if w.endswith("ing"):
        return _strip_ing(w)
    if w.endswith("ed"):
        return _strip_past(w)
    if w.endswith("s"):
        return _strip_plural(w)
    return w
