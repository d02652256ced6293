"""MatchPipeline: the exact -> fuzzy -> semantic lookup cascade as data (the
twin of ``repro.memory.pipeline``).

A :class:`MatchPipeline` is an ordered list of stages; each tries to
RESOLVE a query string to a stored key, and the store then serves the
resolved key through its one exact/eviction-accounting path. Stages are
incremental: the store notifies them on insert/remove/clear, so their
indexes never rebuild on the lookup path. A batch notification is one
embedding batch and, on the ``device`` backend, one multi-slot device write.

* :class:`ExactStage`    — dict membership, O(1);
* :class:`FuzzyStage`    — keyword-embedding similarity over the stored keys
  (the paper's fuzzy matching, Tables 5-6);
* :class:`SemanticStage` — similarity over each entry's *insertion context*
  (e.g. the raw task query) against the lookup context: the semantic
  baseline's matcher.

The fuzzy and semantic stages take ``index_backend`` and ``device`` down to
their :class:`~repro_torch.index.SimilarityIndex`.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple


class MatchStage:
    """One resolution stage. Subclasses override ``resolve`` plus whichever
    maintenance hooks their index needs (defaults are no-ops)."""

    name = "stage"

    def on_insert_batch(
        self,
        items: Sequence[Tuple[str, Any]],
        contexts: Sequence[Optional[str]],
        vectors: Optional[Any] = None,
    ) -> None:
        pass

    def on_remove(self, key: str) -> None:
        pass

    def clear(self) -> None:
        pass

    def resolve(
        self,
        queries: Sequence[str],
        contexts: Sequence[Optional[str]],
        contains: Callable[[str], bool],
    ) -> List[Optional[str]]:
        """Per query: the stored key this stage resolves it to, else None.
        ``contains`` is exact membership in the owning store."""
        raise NotImplementedError


class ExactStage(MatchStage):
    """Exact dict membership — the paper's O(1) default (§3.2)."""

    name = "exact"

    def resolve(self, queries, contexts, contains):
        return [q if contains(q) else None for q in queries]


class FuzzyStage(MatchStage):
    """Keyword-embedding similarity over stored keys (the reference's
    ``FuzzyMatcher``, whose every method forwards to its index, is folded
    in here). The hashed-ngram embedding stands in for the paper
    prototype's SentenceTransformer encoder."""

    name = "fuzzy"

    def __init__(self, threshold: float = 0.8, backend: str = "auto", **index_kw):
        from repro_torch.index import SimilarityIndex

        self.threshold = threshold
        self.index = SimilarityIndex(backend=backend, **index_kw)

    def on_insert_batch(self, items, contexts, vectors=None):
        # an admission wave is one embedding batch and, on the ``device``
        # backend, one multi-slot device write
        self.index.add_batch([k for k, _ in items], vectors)

    def on_remove(self, key):
        self.index.remove(key)

    def clear(self):
        self.index.clear()

    def resolve(self, queries, contexts, contains):
        # one embedding batch and one top-k call (one kernel launch on the
        # ``pallas``/``device`` backends) for the whole batch
        return self.index.best_match_batch(list(queries), self.threshold)

    def autotune(self, **thresholds) -> Optional[str]:
        return self.index.autotune(**thresholds)


class SemanticStage(MatchStage):
    """Similarity over each entry's insertion *context* text.

    At insert the stage embeds ``context`` (falling back to the key, which
    makes a query-keyed store like the semantic baseline work unchanged);
    at lookup it embeds the lookup context (falling back to the query) and
    returns the stored key whose context is most similar above
    ``threshold``. Lookup vectors are embedded once per batch.
    """

    name = "semantic"

    def __init__(self, threshold: float = 0.85, backend: str = "auto", **index_kw):
        from repro_torch.index import SimilarityIndex

        self.threshold = threshold
        self.index = SimilarityIndex(backend=backend, **index_kw)

    def on_insert_batch(self, items, contexts, vectors=None):
        # `vectors` are KEY embeddings (for key-matching stages); this stage
        # matches on context text, so it always embeds the contexts itself
        from repro_torch.index import embed_batch

        keys = [k for k, _ in items]
        texts = [c if c is not None else k for k, c in zip(keys, contexts)]
        self.index.add_batch(keys, embed_batch(texts))

    def on_remove(self, key):
        self.index.remove(key)

    def clear(self):
        self.index.clear()

    def resolve(self, queries, contexts, contains):
        from repro_torch.index import embed_batch

        texts = [c if c is not None else q for q, c in zip(queries, contexts)]
        return self.index.best_match_batch(embed_batch(texts), self.threshold)

    def autotune(self, **thresholds) -> Optional[str]:
        return self.index.autotune(**thresholds)


class MatchPipeline:
    """Ordered stages; the store broadcasts maintenance to all of them and
    walks them in order at lookup, narrowing to still-unresolved queries."""

    def __init__(self, stages: Sequence[MatchStage]):
        self.stages: List[MatchStage] = list(stages)
        names = [s.name for s in self.stages]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate stage names in pipeline: {names}")

    def stage(self, name: str) -> Optional[MatchStage]:
        for s in self.stages:
            if s.name == name:
                return s
        return None

    def on_insert_batch(self, items, contexts, vectors=None) -> None:
        for s in self.stages:
            s.on_insert_batch(items, contexts, vectors)

    def on_remove(self, key: str) -> None:
        for s in self.stages:
            s.on_remove(key)

    def clear(self) -> None:
        for s in self.stages:
            s.clear()


def build_pipeline(
    spec: Sequence[str],
    *,
    fuzzy_threshold: float = 0.8,
    semantic_threshold: float = 0.85,
    index_backend: str = "auto",
    device=None,
    obs: Optional[Any] = None,
    obs_labels: Optional[dict] = None,
) -> MatchPipeline:
    """Build a pipeline from stage names (``exact`` | ``fuzzy`` |
    ``semantic``), in cascade order.
    ``device`` is where a ``pallas``/``device`` index searches (CUDA unless
    the caller asks for another). ``obs`` (a
    :class:`repro_torch.obs.MetricsRegistry`) and ``obs_labels`` ride down
    to each stage's index, whose telemetry registers there with an added
    ``stage=<name>`` label."""
    base = dict(obs_labels or {})

    def stage_kw(name: str) -> dict:
        kw = {"device": device}
        if obs is not None or base:
            kw.update(obs=obs, obs_labels=dict(base, stage=name))
        return kw

    stages: List[MatchStage] = []
    for item in spec:
        if item == "exact":
            stages.append(ExactStage())
        elif item == "fuzzy":
            stages.append(FuzzyStage(fuzzy_threshold, index_backend, **stage_kw("fuzzy")))
        elif item == "semantic":
            stages.append(SemanticStage(semantic_threshold, index_backend,
                                        **stage_kw("semantic")))
        else:
            raise ValueError(
                f"unknown pipeline stage {item!r} "
                "(expected 'exact' | 'fuzzy' | 'semantic')"
            )
    return MatchPipeline(stages)


__all__ = [
    "ExactStage",
    "FuzzyStage",
    "MatchPipeline",
    "MatchStage",
    "SemanticStage",
    "build_pipeline",
]
