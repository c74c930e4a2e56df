"""Host-side text front end: object mention extraction, relation extraction
and layout inference; port of the JAX package's `pipeline/frontend.py`.

Reference: `inference/inference_coco.py:436-544`: noun chunks filtered by
`check_in_mscoco` (a COCO category name appearing as a substring of the
phrase), the chunk's root word aligned to a RoBERTa token, and the GMM
head's (x, y) read at that token.

Everything but the forward is the JAX module's host Python, copied.  The
JAX module uses spaCy's noun chunks when spaCy imports and a deterministic
n-gram matcher otherwise; spaCy is on neither this package's dependency
list nor the card's machine, so the port has the n-gram matcher only,
which is the branch the JAX package takes wherever spaCy is absent.  The
forward is one `torch.inference_mode` call of the port's
`LayoutPredictor.predict_xy` on the model's own device.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.layout.gmm_head import split_gmm

# The 80 COCO category names (public; the reference unpickles the same list
# from `data/coco/category_dict.pkl`).
COCO_CATEGORIES = [
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella", "handbag",
    "tie", "suitcase", "frisbee", "skis", "snowboard", "sports ball", "kite",
    "baseball bat", "baseball glove", "skateboard", "surfboard",
    "tennis racket", "bottle", "wine glass", "cup", "fork", "knife", "spoon",
    "bowl", "banana", "apple", "sandwich", "orange", "broccoli", "carrot",
    "hot dog", "pizza", "donut", "cake", "chair", "couch", "potted plant",
    "bed", "dining table", "toilet", "tv", "laptop", "mouse", "remote",
    "keyboard", "cell phone", "microwave", "oven", "toaster", "sink",
    "refrigerator", "book", "clock", "vase", "scissors", "teddy bear",
    "hair drier", "toothbrush",
]


# Common-usage synonyms mapped to their COCO category.  The reference builds
# a WordNet synonym/plural set per category (`inference_coco.py:441-470`) but
# its `check_in_mscoco` substring test never consults it — measured on the
# benchmark prompts, that drops e.g. every "television" mention (gpt GT says
# "tv").  The n-gram matcher honors the synonyms the reference collected.
CATEGORY_ALIASES: Dict[str, str] = {
    "television": "tv", "tv set": "tv",
    "bike": "bicycle",
    "motorbike": "motorcycle",
    "aeroplane": "airplane", "plane": "airplane",
    "sofa": "couch",
    "cellphone": "cell phone", "mobile phone": "cell phone",
    "doughnut": "donut",
    "fridge": "refrigerator",
    "hair dryer": "hair drier", "hairdryer": "hair drier",
    "wineglass": "wine glass",
}


def canonical_category(name: str) -> str:
    """Map a free-form object name to its COCO category when a known
    synonym, else return it unchanged (lowercased)."""
    low = name.strip().lower()
    return CATEGORY_ALIASES.get(low, low)


def _plural_forms(word: str) -> List[str]:
    if word.endswith(("s", "x", "z", "ch", "sh")):
        return [word + "es"]
    if word.endswith("y") and word[-2] not in "aeiou":
        return [word[:-1] + "ies"]
    return [word + "s"]


@dataclasses.dataclass
class ObjectMention:
    phrase: str       # the noun phrase as found (e.g. "the silver bed")
    category: str     # matched COCO category
    word_index: int   # index of the category's head word in the word list


def simple_words(sentence: str) -> List[str]:
    return re.findall(r"\w+|[^\w\s]", sentence)


def extract_objects(
    sentence: str, categories: Sequence[str] = COCO_CATEGORIES
) -> Tuple[List[str], List[ObjectMention]]:
    """Find COCO-category mentions by matching category n-grams (simple
    plurals and the aliases included) over the word sequence, the JAX
    package's matcher where spaCy is absent."""
    sentence = sentence.strip()
    words = simple_words(sentence)
    low = [w.lower() for w in words]
    taken = set()
    mentions = []
    # name → canonical category, synonyms included (see CATEGORY_ALIASES)
    entries = [(cat, cat) for cat in categories]
    entries += [(alias, cat) for alias, cat in CATEGORY_ALIASES.items()
                if cat in categories]
    # longest names first so "wine glass" wins over "glass"-less "cup"
    for name, cat in sorted(entries, key=lambda e: len(e[0]), reverse=True):
        cat_words = name.split()
        variants = [cat_words]
        variants += [cat_words[:-1] + [p] for p in _plural_forms(cat_words[-1])]
        n = len(cat_words)
        for i in range(len(low) - n + 1):
            if any(low[i : i + n] == v for v in variants):
                span = set(range(i, i + n))
                if span & taken:
                    continue
                taken |= span
                head = i + n - 1
                # include leading adjectives/determiner in the phrase, like a
                # noun chunk would
                start = i
                while start > 0 and re.fullmatch(r"[A-Za-z]+", words[start - 1]) and \
                        low[start - 1] not in {"of", "and", "with", "on", "in", "at"}:
                    start -= 1
                    if low[start] in {"the", "a", "an"}:
                        break
                phrase = " ".join(words[start : i + n])
                mentions.append(ObjectMention(phrase, cat, head))
    mentions.sort(key=lambda m: m.word_index)
    return words, mentions


# Relation cue word-sequences scanned in the gap between object mentions,
# longest-first so "on top of" wins before "top"/"over" variants fire.
# Canonical semantics match `eval.metrics.relation_pass`
# (`relation_result_gpt.py:95-110`): "a left of b" ⇒ x_a < x_b,
# "a above b" ⇒ y_a < y_b (y down).
_REL_CUES: List[Tuple[Tuple[str, ...], str]] = [
    (("on", "top", "of"), "above"),
    # verb + "on": support ⇒ A above B (bare "on" is too ambiguous)
    (("placed", "on"), "above"),
    (("sits", "on"), "above"),
    (("sat", "on"), "above"),
    (("sitting", "on"), "above"),
    (("rests", "on"), "above"),
    (("resting", "on"), "above"),
    (("rested", "on"), "above"),
    (("stands", "on"), "above"),
    (("standing", "on"), "above"),
    (("perched", "on"), "above"),
    (("lying", "on"), "above"),
    (("lies", "on"), "above"),
    (("left", "of"), "left of"),     # also covers "to the left of",
    (("left", "side", "of"), "left of"),
    (("right", "of"), "right of"),
    (("right", "side", "of"), "right of"),
    (("above",), "above"),
    (("atop",), "above"),
    (("over",), "above"),
    (("below",), "below"),
    (("beneath",), "below"),
    (("under",), "below"),
    (("underneath",), "below"),
]

_REL_INVERSE = {"above": "below", "below": "above",
                "left of": "right of", "right of": "left of"}


def _close_category_relations(
    triples: List[Tuple[str, str, str]],
) -> List[Tuple[str, str, str]]:
    """Transitive closure per axis over category-level triples (mirrors
    `training.datasets.close_relations_transitively`, but on category
    names): chained phrasings like "A left of B … B left of C" imply
    A left of C.  Contradictory inferred pairs are dropped."""
    have = set(triples)
    edges = {"above": set(), "left of": set()}
    for a, b, rel in triples:
        if rel in edges:
            edges[rel].add((a, b))
        else:
            edges[_REL_INVERSE[rel]].add((b, a))
    out = list(triples)
    for rel, e in edges.items():
        closure = set(e)
        changed = True
        while changed:
            changed = False
            for a, b in list(closure):
                for c, d in list(closure):
                    if b == c and a != d and (a, d) not in closure:
                        closure.add((a, d))
                        changed = True
        for a, b in sorted(closure - e):
            if (b, a) in closure:
                continue
            if (a, b, rel) in have or (b, a, _REL_INVERSE[rel]) in have:
                continue
            out.append((a, b, rel))
            have.add((a, b, rel))
    return out


def extract_relations(
    words: List[str], mentions: List[ObjectMention]
) -> List[Tuple[str, str, str]]:
    """Surface-text spatial relations between object mentions →
    (category_a, category_b, rel) triples, transitively closed.

    High-precision rules only (every extracted triple steers the decode):
    1. a relation cue (`_REL_CUES`) in the word gap between two adjacent
       mentions ⇒ "A rel B";
    2. the post-positioned possessive "… B … to its/their left" ⇒
       "B left of A" where A is the nearest earlier mention of a
       different category (reference-corpus phrasing like "the person …
       with the bowl positioned to their left");
    3. transitive closure per axis over the extracted graph.
    Contradictory pairs are dropped rather than guessed.  Uses only the
    input sentence — no evaluation data is consulted.
    """
    low = [w.lower() for w in words]
    triples: List[Tuple[str, str, str]] = []

    # support cues ("placed on", "sits on", …) bind tightly: their object
    # must be the very next NP, so the cue has to sit at the END of the
    # gap (else "lying on the ground, with the bowl …" reads as
    # A-on-bowl).  Directional/vertical cues may appear anywhere.
    _TIGHT = {cue for cue, rel in _REL_CUES
              if cue[-1] == "on" and len(cue) > 1}

    def scan_gap(gap_lo: int, gap_hi: int) -> Optional[str]:
        gap = low[gap_lo:gap_hi]
        for cue, rel in _REL_CUES:
            n = len(cue)
            for i in range(len(gap) - n + 1):
                if tuple(gap[i:i + n]) == cue:
                    if cue in _TIGHT and i + n < len(gap) - 3:
                        continue
                    return rel
        return None

    conj = {"and", "or", "both", "the", "a", "an", ","}
    last_gap = {}  # m_b word_index → (subject category, rel) for extension
    for m_a, m_b in zip(mentions, mentions[1:]):
        rel = scan_gap(m_a.word_index + 1, m_b.word_index)
        if rel and m_a.category != m_b.category:
            triples.append((m_a.category, m_b.category, rel))
            last_gap[m_b.word_index] = (m_a.category, rel)
        elif rel is None and last_gap.get(m_a.word_index) and set(
                low[m_a.word_index + 1:m_b.word_index]) <= conj:
            # conjunction extension: "beneath both the dog and the horse"
            # carries the cue across the coordinated NP list
            subj, prel = last_gap[m_a.word_index]
            if subj != m_b.category:
                triples.append((subj, m_b.category, prel))
                last_gap[m_b.word_index] = (subj, prel)

    poss = ("its", "their", "his", "her")
    pron = ("them", "him", "her", "it", "us")

    def nearest_before(i, exclude_cat=None, person=None):
        """Nearest mention left of word i; optionally filter by category
        (person=True/False) or exclude one category."""
        for m in reversed([m for m in mentions if m.word_index < i]):
            if exclude_cat is not None and m.category == exclude_cat:
                continue
            if person is True and m.category != "person":
                continue
            if person is False and m.category == "person":
                continue
            return m
        return None

    def resolve_possessor(i, pronoun):
        """their/his/her → nearest person mention; its → nearest
        non-person mention (this corpus's pronoun agreement)."""
        return nearest_before(i, person=(pronoun != "its"))

    _its_ref = [None]  # last resolved "its" possessor (list coordination)
    for i, w in enumerate(low):
        # A. vertical + pronoun: "hovering (just) above them", "underneath
        #    it" ⇒ located REL referent.  The located object is the nearest
        #    mention (the clause's own subject: "…, with the knife resting
        #    above it"); the pronoun referent is the nearest PERSON for
        #    them/him/her, else the nearest different-category mention
        #    before the located one.
        if w in ("above", "over", "below", "beneath", "under", "underneath"):
            j = i + 1
            if j < len(low) and low[j] in ("just", "directly", "right"):
                j += 1
            if j < len(low) and low[j] in pron:
                rel = "above" if w in ("above", "over") else "below"
                loc = nearest_before(i)
                if loc is None:
                    continue
                if low[j] == "it":
                    ref = nearest_before(loc.word_index,
                                         exclude_cat=loc.category)
                else:
                    ref = nearest_before(i, person=True)
                    if ref is not None and ref.category == loc.category:
                        loc = nearest_before(i, exclude_cat=ref.category)
                if loc and ref and loc.category != ref.category:
                    triples.append((loc.category, ref.category, rel))
            continue
        # B. "at their/its feet" ⇒ located below referent
        if w == "at" and i + 2 < len(low) and low[i + 1] in poss \
                and low[i + 2] == "feet":
            ref = resolve_possessor(i, low[i + 1])
            loc = ref and nearest_before(i, exclude_cat=ref.category)
            if loc and ref:
                triples.append((loc.category, ref.category, "below"))
            continue
        # C/E. "(to|on) its/their left|right".  For person pronouns the
        #    possessor is the nearest person mention and the located object
        #    the nearest non-possessor mention ("with the bowl positioned
        #    to their left" ⇒ bowl left of person).  For "its" the corpus
        #    has two constructions, disambiguated by the clause introducer
        #    between the previous mention and the cue:
        #      · subordinate clause ("with/while/and/by … X … to its R")
        #        ⇒ located = nearest mention X, possessor = the mention
        #          before it ("the giraffe stood tall, with the horse
        #          grazing to its right" ⇒ horse right of giraffe);
        #      · subject motion ("the bird flew away from the elephant to
        #        its left") ⇒ possessor = nearest mention, located = the
        #          subject before it.
        #    The "leaving X behind on its R" idiom keeps the sentence
        #    subject as possessor.
        if w in ("to", "on") and i + 2 < len(low) and low[i + 1] in poss \
                and low[i + 2] in ("left", "right"):
            if i + 3 < len(low) and low[i + 3] in ("hand", "arm"):
                continue  # camera-mirrored ~50/50 in the corpus: skip
            side = low[i + 2] + " of"
            if "behind" in low[max(0, i - 4):i] and mentions:
                ref = mentions[0]
                loc = nearest_before(i, exclude_cat=ref.category)
            elif low[i + 1] != "its":
                ref = nearest_before(i, person=True)
                loc = ref and nearest_before(i, exclude_cat=ref.category)
            else:
                n = nearest_before(i)
                if n is None:
                    continue
                prev = nearest_before(n.word_index, exclude_cat=n.category)
                if prev is None:
                    continue
                span = low[prev.word_index + 1:i]
                if "between" in span:
                    # "A parked between a car to its right and …": the
                    # possessor is the mention before "between"
                    b_at = prev.word_index + 1 + span.index("between")
                    ref, loc = nearest_before(b_at), n
                elif "and" in span and _its_ref[0] is not None:
                    # coordinated list shares the possessor: "flanked by a
                    # X to its right and a Y to its left"
                    ref, loc = _its_ref[0], n
                elif {"with", "while", "and", "by", "which",
                      "that"} & set(span):
                    loc, ref = n, prev
                else:
                    loc, ref = prev, n
                if ref is not None:
                    _its_ref[0] = ref
            if loc and ref and loc.category != ref.category:
                triples.append((loc.category, ref.category, side))
            continue
        # C2. "(left|right) of it/them": pronoun OBJECT — "with a red
        #     umbrella placed to the left of it" ⇒ umbrella left of the
        #     previous clause's object
        if w in ("left", "right") and i + 2 < len(low) \
                and low[i + 1] == "of" and low[i + 2] in pron:
            side = w + " of"
            loc = nearest_before(i)
            if loc is None:
                continue
            if low[i + 2] == "it":
                ref = nearest_before(loc.word_index, exclude_cat=loc.category)
            else:
                ref = nearest_before(i, person=True)
            if loc and ref and loc.category != ref.category:
                triples.append((loc.category, ref.category, side))
            continue
        # D. "(on|from|to|at) the left|right" with no trailing "(side) of"
        #    ⇒ located SIDE of the preceding other mention
        if w in ("on", "from", "to", "at") and i + 2 < len(low) \
                and low[i + 1] == "the" and low[i + 2] in ("left", "right"):
            nxt = low[i + 3:i + 5]
            if nxt[:1] == ["of"] or nxt == ["side", "of"]:
                continue  # a gap cue ("to the left of …") — rule 1's job
            side = low[i + 2] + " of"
            if "behind" in low[max(0, i - 4):i] and mentions:
                ref = mentions[0]
                loc = nearest_before(i, exclude_cat=ref.category)
            elif "between" in low[:i]:
                # "A between B and C, with B to the left and C to the
                # right" ⇒ sides are relative to the between-subject
                b_at = low.index("between")
                ref = nearest_before(b_at)
                loc = ref and nearest_before(i, exclude_cat=ref.category)
            else:
                loc = nearest_before(i)
                ref = loc and nearest_before(
                    loc.word_index, exclude_cat=loc.category)
            if loc and ref and loc.category != ref.category:
                triples.append((loc.category, ref.category, side))
            continue
        # ("in their left|right hand" is deliberately NOT a rule: measured
        # on the corpus, the GT mirrors the camera on ~half of those rows —
        # a coin-flip cue would poison the decode.)
        # F. "over their left|right shoulder" (not mirrored in the corpus)
        if w in ("their", "his", "her", "its") and i + 2 < len(low) \
                and low[i + 1] in ("left", "right") \
                and low[i + 2] == "shoulder":
            ref = nearest_before(i, person=True)
            loc = ref and nearest_before(i, exclude_cat=ref.category)
            if loc and ref:
                triples.append((loc.category, ref.category,
                                low[i + 1] + " of"))
            continue
        # G. "positioned lower/higher" (comparative, no explicit pair)
        if w in ("lower", "higher") and (i + 1 >= len(low)
                                         or low[i + 1] != "than"):
            loc = nearest_before(i)
            ref = loc and nearest_before(
                loc.word_index, exclude_cat=loc.category)
            if loc and ref:
                rel = "below" if w == "lower" else "above"
                triples.append((loc.category, ref.category, rel))
            continue

    # dedupe, drop self-relations and direct contradictions
    seen, out = set(), []
    for t in triples:
        a, b, rel = t
        if a == b or t in seen:
            continue
        if (b, a, rel) in seen or (a, b, _REL_INVERSE[rel]) in seen:
            continue
        seen.add(t)
        out.append(t)
    return _close_category_relations(out)


def local_context_prompt(mention: ObjectMention) -> str:
    """Per-object ATTENTION context text (reference `txt2img-gpt.py:320`):
    'a photo of ' + the raw noun phrase."""
    return "a photo of " + mention.phrase


def local_loss_prompt(mention: ObjectMention) -> str:
    """Per-object CLIP-LOSS text (reference `plms.py:267-270`): lowercase,
    'the ' stripped, 'A photo of ' prefix — note this differs from the
    attention-context string above in the reference too."""
    name = mention.phrase.lower().replace("the ", "")
    return "A photo of " + name


# backwards-compat alias (loss-side variant)
local_prompt = local_loss_prompt


class LayoutInference:
    """`inference_sentence` equivalent: sentence → {phrase: (x, y)}.

    Bundles the LayoutPredictor (weights inside, on its device) with the
    host front end and a word-aligned tokenizer (reference
    `inference_coco.py:486-544`).
    """

    def __init__(self, model, tokenizer, max_len: Optional[int] = None,
                 relation_aware: bool = True, beam_width: int = 128):
        self.model = model
        self.tokenizer = tokenizer
        # Default to the model's OWN max_len: load_layout_predictor rebuilds
        # the config from the checkpoint's config.json, so a caller-side cfg
        # can be stale (silently truncating/mis-padding on checkpoints
        # trained with non-default max_len).
        if max_len is None:
            max_len = getattr(getattr(model, "cfg", None), "max_len", 128)
        self.max_len = max_len
        # Relation-aware decode: instead of each token's argmax-component
        # mean (the reference's GREEDY=True mode), choose the GMM component
        # per object that JOINTLY satisfies the spatial relations extracted
        # from the input sentence (`extract_relations` — surface text only).
        # Falls back to exactly the greedy decode when no relations are
        # found, so this strictly generalizes the reference behavior.
        self.relation_aware = relation_aware
        self.beam_width = beam_width
        self.device = next(model.parameters()).device
        self._stream = None

    def _forward(self, tokens: np.ndarray, object_pos: np.ndarray):
        """(xy [L, 2], raw [L, 6K]) as numpy of one padded sentence, greedy
        component: one forward on the model's device.  On a card it runs on
        a stream of its own, so reading the result back waits for this
        forward only and not for work queued before it (the batch a
        `BatchedRunner` has in flight while it lays out the next chunk)."""
        if self.device.type == "cuda" and self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._stream.wait_stream(torch.cuda.current_stream(self.device))  # the weights
        with torch.inference_mode(), torch.cuda.stream(self._stream):
            xy, raw = self.model.predict_xy(
                torch.as_tensor(tokens, dtype=torch.int64, device=self.device),
                torch.as_tensor(object_pos, device=self.device), greedy_component=True)
            return xy[0].cpu().numpy(), raw[0].cpu().numpy()

    def _relation_decode(
        self,
        mentions: List[ObjectMention],
        tok_idx: List[int],
        raw: np.ndarray,                       # [L, 6K]
        relations: List[Tuple[str, str, str]],
    ) -> Dict[str, List[float]]:
        """Beam search over per-object GMM components maximizing
        (#satisfied relations, Σ log π) — lexicographic via a large bonus."""
        k = raw.shape[-1] // 6
        p = split_gmm(torch.from_numpy(np.ascontiguousarray(raw[np.asarray(tok_idx)])), k)
        logpi = np.log(np.clip(p.pi.numpy(), 1e-12, None))       # [N, K]
        mx, my = p.mu_x.numpy(), p.mu_y.numpy()                  # [N, K]

        # constrain the FIRST mention of each category (the one the
        # consistency protocol reads); later duplicates follow greedily
        first_of = {}
        for n, m in enumerate(mentions):
            first_of.setdefault(m.category, n)
        rel_pairs = []  # (slot_a, slot_b, axis, sign): sign·(c_b − c_a) > 0
        for a, b, rel in relations:
            if a not in first_of or b not in first_of:
                continue
            axis = 1 if rel in ("above", "below") else 0
            sign = 1.0 if rel in ("above", "left of") else -1.0
            rel_pairs.append((first_of[a], first_of[b], axis, sign))
        if not rel_pairs:
            choice = np.argmax(logpi, axis=-1)
        else:
            BONUS = 1e3  # one satisfied relation outweighs any π margin
            beams = [((), 0.0)]
            for n in range(len(mentions)):
                scored = []
                for combo, score in beams:
                    for c in range(k):
                        s = score + logpi[n, c]
                        nxt = combo + (c,)
                        for sa, sb, ax, sg in rel_pairs:
                            if max(sa, sb) != n or min(sa, sb) > n:
                                continue  # undecided pair
                            ca = (mx, my)[ax][sa, nxt[sa]]
                            cb = (mx, my)[ax][sb, nxt[sb]]
                            if sg * (cb - ca) > 0:
                                s += BONUS
                        scored.append((nxt, s))
                scored.sort(key=lambda t: -t[1])
                beams = scored[: self.beam_width]
            choice = np.asarray(beams[0][0])
        # a repeated category mention is the same object: every duplicate
        # reports the constrained (first) slot's center, so identical-phrase
        # dict collapse can't drop the constrained placement
        out = {}
        for m in mentions:
            s = first_of[m.category]
            out[m.phrase] = [float(mx[s, choice[s]]), float(my[s, choice[s]])]
        return out

    def __call__(self, sentence: str) -> Optional[Dict[str, List[float]]]:
        words, mentions = extract_objects(sentence)
        if not mentions:
            return None
        ids, align = self.tokenizer.encode_with_alignment(words)
        tokens = np.asarray(
            self.tokenizer.pad_to(ids, self.max_len), np.int32
        )[None]
        object_pos = np.zeros((1, self.max_len), np.float32)
        tok_idx = []
        for m in mentions:
            if m.word_index >= len(align) or align[m.word_index] >= self.max_len:
                return None
            t = align[m.word_index]
            object_pos[0, t] = 1.0
            tok_idx.append(t)
        xy, raw = self._forward(tokens, object_pos)
        if self.relation_aware:
            relations = extract_relations(words, mentions)
            if relations:
                return self._relation_decode(mentions, tok_idx, raw, relations)
        return {m.phrase: [float(xy[t, 0]), float(xy[t, 1])] for m, t in zip(mentions, tok_idx)}

    def mentions_and_centers(self, sentence: str):
        """Like __call__ but returns (mentions, centers[N,2]) for pipelines."""
        res = self(sentence)
        if res is None:
            return None
        _, mentions = extract_objects(sentence)
        centers = np.array(list(res.values()), np.float32)
        return mentions, centers
