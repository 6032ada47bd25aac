"""Synthetic instruction-generation pipelines: MathScale + GLAN.

Capability-equivalents of the reference's data-generation projects, which
ship as papers + benchmark code only (mathscale/README.md -> arXiv
2403.02884; glan/README.md -> arXiv 2402.13064):

  MathScale  seed problems -> concept extraction (topics + knowledge
             points) -> co-occurrence concept graph -> weighted random-walk
             sampling -> question/answer generation.
  GLAN       taxonomy of disciplines -> subjects per discipline -> syllabus
             (class sessions + key concepts) -> homework questions per
             (session, concept-subset) combination.

Every LLM call goes through a pluggable ``LLMClient = Callable[[str], str]``
so the pipelines are pure scaffolding: tests drive them with deterministic
scripted clients (no network), production plugs in a real API client or an
in-framework model via runtime/generate.py. All randomness comes from an
explicit numpy Generator — runs are reproducible by seed.

Parsing contract: clients answer with one item per line; concept extraction
uses ``Topics: a; b`` / ``Knowledge: x; y`` lines. Malformed lines are
skipped, mirroring the tolerant parsing the reference's pipelines need when
driving real LLMs.

The port's copy of unilm_tpu/data/instructgen.py
(pure Python: the port imports nothing of the JAX package), held
against it by the CPU tests.
"""

from __future__ import annotations

import dataclasses
import re
from collections import Counter, defaultdict
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

LLMClient = Callable[[str], str]


def _lines(text: str) -> List[str]:
    out = []
    for line in text.splitlines():
        line = re.sub(r"^\s*(?:[-*]|\d+[.)])\s*", "", line).strip()
        if line:
            out.append(line)
    return out


# --------------------------------------------------------------------------- #
# MathScale
# --------------------------------------------------------------------------- #

EXTRACT_PROMPT = (
    "Analyze the following math question and identify the high-level topics "
    "and the fine-grained knowledge points it exercises.\n"
    "Question: {question}\n"
    "Reply with exactly two lines:\n"
    "Topics: <topic>; <topic>; ...\n"
    "Knowledge: <point>; <point>; ..."
)

COMPOSE_PROMPT = (
    "Create one new {difficulty} math word problem that combines the topics "
    "[{topics}] and exercises the knowledge points [{points}]. "
    "Reply with the problem statement only."
)

SOLVE_PROMPT = (
    "Solve the following problem step by step and end with "
    "'The answer is ...'.\nProblem: {question}"
)


def extract_concepts(
    client: LLMClient, questions: Sequence[str]
) -> List[Tuple[List[str], List[str]]]:
    """Per question: (topics, knowledge points) from the two-line reply."""
    out = []
    for q in questions:
        reply = client(EXTRACT_PROMPT.format(question=q))
        topics: List[str] = []
        points: List[str] = []
        for line in reply.splitlines():
            m = re.match(r"\s*(topics|knowledge)\s*:\s*(.*)", line, re.I)
            if not m:
                continue
            items = [x.strip().lower() for x in m.group(2).split(";") if x.strip()]
            (topics if m.group(1).lower() == "topics" else points).extend(items)
        out.append((topics, points))
    return out


@dataclasses.dataclass
class ConceptGraph:
    """Co-occurrence graph over topics (kind 't') and knowledge points
    (kind 'k'). Edge weight = number of seed questions where both occur."""

    freq: Counter = dataclasses.field(default_factory=Counter)
    kind: Dict[str, str] = dataclasses.field(default_factory=dict)
    adj: Dict[str, Counter] = dataclasses.field(
        default_factory=lambda: defaultdict(Counter))

    @classmethod
    def build(cls, extracted: Iterable[Tuple[Sequence[str], Sequence[str]]]
              ) -> "ConceptGraph":
        g = cls()
        for topics, points in extracted:
            nodes = [(t, "t") for t in dict.fromkeys(topics)] + \
                    [(p, "k") for p in dict.fromkeys(points)]
            for name, kind in nodes:
                g.freq[name] += 1
                g.kind[name] = kind
            for i, (a, _) in enumerate(nodes):
                for b, _ in nodes[i + 1:]:
                    if a != b:
                        g.adj[a][b] += 1
                        g.adj[b][a] += 1
        return g

    def nodes(self, kind: Optional[str] = None) -> List[str]:
        return [n for n in self.freq if kind is None or self.kind[n] == kind]

    def _step(self, rng: np.random.Generator, frm: str,
              kind: str, exclude: set) -> Optional[str]:
        cands = [(n, w) for n, w in self.adj[frm].items()
                 if self.kind[n] == kind and n not in exclude]
        if not cands:
            return None
        names, ws = zip(*cands)
        p = np.asarray(ws, np.float64)
        return str(names[rng.choice(len(names), p=p / p.sum())])

    def sample_concepts(
        self, rng: np.random.Generator,
        max_topics: int = 2, max_points: int = 5,
    ) -> Tuple[List[str], List[str]]:
        """Frequency-weighted start topic, then a weighted random walk to
        sibling topics and on to knowledge points (MathScale §2.2)."""
        topics_all = self.nodes("t")
        if not topics_all:
            return [], []
        w = np.asarray([self.freq[t] for t in topics_all], np.float64)
        start = topics_all[rng.choice(len(topics_all), p=w / w.sum())]
        topics = [start]
        while len(topics) < max_topics:
            nxt = self._step(rng, topics[-1], "t", set(topics))
            if nxt is None or rng.random() < 0.5:
                break
            topics.append(nxt)
        points: List[str] = []
        n_points = int(rng.integers(1, max_points + 1))
        frontier = list(topics)
        while len(points) < n_points and frontier:
            nxt = self._step(rng, frontier[int(rng.integers(len(frontier)))],
                             "k", set(points))
            if nxt is None:
                break
            points.append(nxt)
            frontier.append(nxt)
        return topics, points


def mathscale_generate(
    client: LLMClient,
    seed_questions: Sequence[str],
    n: int,
    seed: int = 0,
    difficulty: str = "challenging",
    graph: Optional[ConceptGraph] = None,
) -> List[Dict[str, str]]:
    """Full MathScale loop: extract -> graph -> sample -> compose -> solve.
    Returns [{question, answer, topics, knowledge_points}]."""
    rng = np.random.default_rng(seed)
    if graph is None:
        graph = ConceptGraph.build(extract_concepts(client, seed_questions))
    out = []
    for _ in range(n):
        topics, points = graph.sample_concepts(rng)
        if not topics:
            break
        q = client(COMPOSE_PROMPT.format(
            difficulty=difficulty, topics="; ".join(topics),
            points="; ".join(points))).strip()
        a = client(SOLVE_PROMPT.format(question=q)).strip()
        out.append({"question": q, "answer": a,
                    "topics": topics, "knowledge_points": points})
    return out


# --------------------------------------------------------------------------- #
# GLAN
# --------------------------------------------------------------------------- #

TAXONOMY_PROMPT = (
    "List the main disciplines in a taxonomy of human knowledge and "
    "capability. One discipline per line."
)

SUBJECTS_PROMPT = (
    "List {k} foundational subjects a student of {discipline} must master. "
    "One subject per line."
)

SYLLABUS_PROMPT = (
    "Design a syllabus for the subject '{subject}' ({discipline}). "
    "Reply with one class session per line in the form "
    "<session title> :: <key concept>; <key concept>; ..."
)

QUESTION_PROMPT = (
    "Write one {difficulty} homework question for the class session "
    "'{session}' of the subject '{subject}' that tests the concepts "
    "[{concepts}]. Reply with the question only."
)

ANSWER_PROMPT = (
    "Answer the following homework question thoroughly.\nQuestion: {question}"
)


@dataclasses.dataclass
class ClassSession:
    title: str
    concepts: List[str]


def build_syllabus(client: LLMClient, discipline: str,
                   subject: str) -> List[ClassSession]:
    sessions = []
    for line in _lines(client(SYLLABUS_PROMPT.format(
            subject=subject, discipline=discipline))):
        if "::" not in line:
            continue
        title, concepts = line.split("::", 1)
        cs = [c.strip() for c in concepts.split(";") if c.strip()]
        if title.strip() and cs:
            sessions.append(ClassSession(title.strip(), cs))
    return sessions


def glan_generate(
    client: LLMClient,
    n_per_session: int = 1,
    subjects_per_discipline: int = 3,
    max_concepts: int = 2,
    seed: int = 0,
    difficulty: str = "college-level",
    disciplines: Optional[Sequence[str]] = None,
) -> List[Dict[str, str]]:
    """Full GLAN loop: taxonomy -> subjects -> syllabus -> questions.
    Returns [{discipline, subject, session, concepts, question, answer}]."""
    rng = np.random.default_rng(seed)
    if disciplines is None:
        disciplines = _lines(client(TAXONOMY_PROMPT))
    out = []
    for disc in disciplines:
        subjects = _lines(client(SUBJECTS_PROMPT.format(
            k=subjects_per_discipline, discipline=disc)))
        for subj in subjects[:subjects_per_discipline]:
            for sess in build_syllabus(client, disc, subj):
                for _ in range(n_per_session):
                    k = min(max_concepts, len(sess.concepts))
                    idx = rng.choice(len(sess.concepts), size=k, replace=False)
                    concepts = [sess.concepts[i] for i in sorted(idx)]
                    q = client(QUESTION_PROMPT.format(
                        difficulty=difficulty, session=sess.title,
                        subject=subj, concepts="; ".join(concepts))).strip()
                    a = client(ANSWER_PROMPT.format(question=q)).strip()
                    out.append({"discipline": disc, "subject": subj,
                                "session": sess.title, "concepts": concepts,
                                "question": q, "answer": a})
    return out
