"""MongoDB persistence backend.

Copy of `colormipsearch_tpu/dataio/db_mongo.py`.

Direct counterpart of the reference's Mongo DAO layer
(colormipsearch-persist dao/mongo/NeuronMetadataMongoDao.java,
AbstractNeuronMatchesMongoDao.java, dao/DaosProvider.java:23-97):
`MongoStore` exposes the SAME store surface as `db.SqliteStore`, so the
existing `DBCDMIPsReader` / `DBCDMIPsWriter` / `DBNeuronMatchesReader` /
`DBNeuronMatchesWriter` adapters (db.py) work unchanged against either
backend — pass `--db mongodb://host/dbname` instead of a SQLite path.

Semantics preserved (matching the reference DAO):
- neuron metadata keyed by entityId, indexed on mipId / libraryName /
  publishedName (NeuronMetadataMongoDao.java:68-76)
- match upserts keyed on (maskImageRefId, matchedImageRefId) via
  replaceOne(upsert=true) (AbstractNeuronMatchesMongoDao.java:117+)
- score-only field updates for re-runs (updateExistingMatches /
  DBCDScoresOnlyWriter)
- listMatchesLocations = distinct mask mip ids having matches
  (DBNeuronMatchesReader.java:42-64)

pymongo is imported on first use (it is not part of the baked image);
constructing a MongoStore without it raises a clear error. The store is
tested against an in-process fake implementing the narrow pymongo
subset used here (tests/test_db_mongo.py), and a `client` can be
injected directly for that purpose.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from ..model.entities import CDMatchEntity, NeuronEntity, entity_from_dict
from ..persist.idgenerator import TimebasedIdGenerator
from .base import DataSourceParam

_MATCH_SCORE_FIELDS = {
    "normalizedScore", "gradientAreaGap", "highExpressionArea",
    "bidirectionalAreaGap", "matchingPixels", "matchingPixelsRatio",
}


def _connect(uri: str):
    try:
        import pymongo  # deferred: not in the baked image
    except ImportError as e:  # pragma: no cover - env without pymongo
        raise RuntimeError(
            "MongoStore requires pymongo (not installed in this image); "
            "use the SQLite backend (--db path.sqlite) or inject a client"
        ) from e
    return pymongo.MongoClient(uri)


# bulk ops: real pymongo classes when available, otherwise stand-ins
# exposing the same private fields the driver encodes — the test fake's
# bulk_write consumes either shape (the reference bulk-upserts the same
# way, AbstractNeuronMatchesMongoDao.java:117+)
class _UpdateOne:
    def __init__(self, filter, update, upsert=False):
        self._filter, self._doc, self._upsert = filter, update, upsert


class _ReplaceOne:
    def __init__(self, filter, replacement, upsert=False):
        self._filter, self._doc, self._upsert = filter, replacement, upsert


def _op_classes():
    try:  # pragma: no cover - env with real pymongo
        from pymongo import ReplaceOne, UpdateOne
        return UpdateOne, ReplaceOne
    except ImportError:
        return _UpdateOne, _ReplaceOne


_BULK_CHUNK = 1000


def selector_pushdown_clauses(prefix: str, p) -> list:
    """Translate a DataSourceParam into server-side Mongo clauses over
    the DENORMALIZED neuron doc embedded in each match (written at
    upsert time: to_dict embeds maskImage/image).

    This is the reference's NeuronSelectionHelper pushdown
    (dao/mongo/AbstractNeuronMatchesMongoDao.java:117+ with $lookup
    joins); since the needed attrs are already on the match docs, plain
    find-operators suffice — no aggregation pipeline. EVERY
    DataSourceParam field translates (the semantics mirror
    DataSourceParam.matches_entity 1:1), so no host re-filter runs on
    pushed reads."""
    if p is None:
        return []
    from ..model.enums import ProcessingType
    c = []

    def f(name):
        return f"{prefix}.{name}"

    if p.alignment_space:
        c.append({f("alignmentSpace"): p.alignment_space})
    if p.libraries:
        c.append({f("libraryName"): {"$in": list(p.libraries)}})
    if p.mip_ids:
        c.append({f("mipId"): {"$in": list(p.mip_ids)}})
    if p.names:
        c.append({f("publishedName"): {"$in": list(p.names)}})
    if p.valid_name_only:
        # publishedName present, non-empty and not "No Consensus"
        c.append({f("publishedName"):
                  {"$nin": [None, "", p.NO_CONSENSUS]}})
    if p.entity_ids:
        c.append({f("id"): {"$in": [str(i) for i in p.entity_ids]}})
    if p.source_ref_ids:
        c.append({f("sourceRefId"): {"$in": sorted(p.source_ref_ids)}})
    if p.neuron_class:
        c.append({f("class"):
                  f"org.janelia.colormipsearch.model.{p.neuron_class}"})
    if p.datasets:
        # any-overlap: $in on an array field matches any element
        c.append({f("datasetLabels"): {"$in": sorted(p.datasets)}})
    # tag semantics: ANY wanted tag in (tags U all processedTags values)
    tag_fields = [f("tags")] + [f(f"processedTags.{pt.name}")
                                for pt in ProcessingType]
    if p.tags:
        c.append({"$or": [{tf: {"$in": sorted(p.tags)}}
                          for tf in tag_fields]})
    if p.excluded_tags:
        c.append({"$nor": [{tf: {"$in": sorted(p.excluded_tags)}}
                           for tf in tag_fields]})
    if p.annotations:
        c.append({f("neuronTerms"): {"$in": sorted(p.annotations)}})
    if p.excluded_annotations:
        c.append({"$nor": [{f("neuronTerms"):
                            {"$in": sorted(p.excluded_annotations)}}]})
    for stage, wanted in (p.processing_tags or {}).items():
        if wanted:
            c.append({f(f"processedTags.{stage}"):
                      {"$all": sorted(wanted)}})
    return c


_SCORE_DOC_FIELDS = {
    "matchingPixels": "matchingPixels",
    "matchingRatio": "matchingPixelsRatio",
    "matchingPixelsRatio": "matchingPixelsRatio",
    "gradientAreaGap": "gradientAreaGap",
    "bidirectionalAreaGap": "bidirectionalAreaGap",
    "highExpressionArea": "highExpressionArea",
    "normalizedScore": "normalizedScore",
}


def scores_pushdown_clauses(sf) -> list:
    """ScoresFilter -> server-side clauses (ScoresFilter.matches
    semantics: per selector, OR over '|'-joined fields >= min; the -1
    sentinel means every field absent or -1 —
    NeuronSelectionHelper.addNeuronsMatchScoresFilters,
    dao/mongo/NeuronSelectionHelper.java:146-157). In Mongo, null in a
    $in list matches missing fields, which is exactly the 'absent'
    arm."""
    if sf is None or sf.empty:
        return []
    c = []
    for field_name, min_score in sf.selectors:
        fields = [_SCORE_DOC_FIELDS.get(x) for x in field_name.split("|")
                  if x and _SCORE_DOC_FIELDS.get(x)]
        if not fields:
            continue
        if min_score == -1:
            for doc_f in fields:
                c.append({doc_f: {"$in": [None, -1]}})
        elif len(fields) == 1:
            c.append({fields[0]: {"$gte": min_score}})
        else:
            c.append({"$or": [{doc_f: {"$gte": min_score}}
                              for doc_f in fields]})
    return c


class MongoStore:
    """Mongo-backed store with the SqliteStore surface (db.py).

    `uri` is a mongodb:// connection string whose path component names
    the database (defaults to "neuronbridge", the reference's database,
    DaosProvider.java). A pre-built `client` (real or fake) can be
    injected for tests.
    """

    def __init__(self, uri: str = "", client=None, database: str = ""):
        if client is None:
            client = _connect(uri)
        self._client = client
        dbname = database
        if not dbname and uri:
            tail = uri.rsplit("/", 1)[-1]
            if tail and "://" not in tail and "@" not in tail:
                dbname = tail.split("?")[0]
        self._db = client[dbname or "neuronbridge"]
        self.neurons = self._db["neuronMetadata"]
        self.matches = self._db["cdMatches"]
        self.sessions = self._db["matchSessions"]
        self.ppp_matches = self._db["pppMatches"]
        # published-data collections (@PersistenceInfo store names,
        # NeuronPublishedURLs.java:9 / PublishedLMImage.java:12)
        self.published_urls = self._db["publishedURL"]
        self.published_lm_images = self._db["publishedLMImage"]
        self.pppm_urls = self._db["pppmURL"]
        self.id_generator = TimebasedIdGenerator()
        for key in ("mipId", "libraryName", "publishedName"):
            try:
                self.neurons.create_index(key)
            except Exception:
                pass
        for key in ("maskImageRefId", "matchedImageRefId"):
            try:
                self.matches.create_index(key)
            except Exception:
                pass

    def close(self) -> None:
        try:
            self._client.close()
        except Exception:
            pass

    # --- neuron metadata DAO ---

    def upsert_neurons(self, entities: Sequence[NeuronEntity]) -> None:
        _, ReplaceOne = _op_classes()
        # batch identity resolution for id-less entities: ONE indexed
        # mipId query per chunk (NeuronMetadataMongoDao.java:80-110)
        idless_mips = sorted({e.mip_id for e in entities
                              if e.entity_id is None and e.mip_id})
        by_mip = {}
        for i in range(0, len(idless_mips), _BULK_CHUNK):
            for ex in self.neurons.find({"mipId": {
                    "$in": idless_mips[i:i + _BULK_CHUNK]}}):
                by_mip.setdefault(ex.get("mipId"), []).append(ex)
        ops = []
        for e in entities:
            if e.entity_id is None and e.mip_id is not None:
                d = e.to_dict()
                want_input = (d.get("computeFiles") or {}) \
                    .get("InputColorDepthImage")
                for ex in by_mip.get(e.mip_id, ()):
                    if ex.get("class") != d.get("class"):
                        continue
                    ex_input = (ex.get("computeFiles") or {}) \
                        .get("InputColorDepthImage")
                    if want_input and ex_input and want_input != ex_input:
                        continue
                    e.entity_id = ex["_id"]
                    break
            if e.entity_id is None:
                e.entity_id = self.id_generator.generate_id()
            doc = e.to_dict()
            doc["_id"] = e.entity_id
            ops.append(ReplaceOne({"_id": e.entity_id}, doc, upsert=True))
        self._bulk(self.neurons, ops)

    def find_neurons(self, param: DataSourceParam) -> List[NeuronEntity]:
        query = {}
        if param.alignment_space:
            query["alignmentSpace"] = param.alignment_space
        if param.libraries:
            query["libraryName"] = {"$in": list(param.libraries)}
        if param.mip_ids:
            query["mipId"] = {"$in": list(param.mip_ids)}
        if param.names:
            query["publishedName"] = {"$in": list(param.names)}
        docs = sorted(self.neurons.find(query), key=lambda d: d.get("_id", 0))
        entities = []
        for d in docs:
            d = dict(d)
            d.pop("_id", None)
            entities.append(entity_from_dict(d))
        entities = [e for e in entities if param.matches_entity(e)]
        return param.apply_slice(entities)

    def distinct_neuron_values(self, column: str) -> List[str]:
        key = {"mip_id": "mipId", "library_name": "libraryName",
               "published_name": "publishedName",
               "alignment_space": "alignmentSpace"}.get(column)
        if key is None:
            raise ValueError(column)
        return sorted(v for v in self.neurons.distinct(key) if v is not None)

    # --- session DAO (MatchSessionMongoDao analogue) ---

    def create_session(self, session) -> int:
        if session.entity_id is None:
            session.entity_id = self.id_generator.generate_id()
        doc = session.to_dict()
        doc["_id"] = session.entity_id
        self.sessions.replace_one({"_id": session.entity_id}, doc, upsert=True)
        return session.entity_id

    def list_sessions(self):
        return sorted((dict(d) for d in self.sessions.find({})),
                      key=lambda d: d.get("_id", 0))

    # --- PPP matches DAO (pppMatches collection; natural-key upserts
    # matching db.SqliteStore.upsert_ppp_matches) ---

    def upsert_ppp_matches(self, matches) -> int:
        n = 0
        for m in matches:
            if not m.source_em_name or not m.source_lm_name:
                continue
            key = {"sourceEmName": m.source_em_name,
                   "sourceLmName": m.source_lm_name}
            existing = next(iter(self.ppp_matches.find(key)), None)
            if existing is not None:
                m.entity_id = existing["_id"]
            elif m.entity_id is None:
                m.entity_id = self.id_generator.generate_id()
            doc = m.to_dict()
            doc["_id"] = m.entity_id
            doc.update(key)
            self.ppp_matches.replace_one(key, doc, upsert=True)
            n += 1
        return n

    def list_ppp_em_names(self) -> List[str]:
        return sorted(v for v in self.ppp_matches.distinct("sourceEmName")
                      if v)

    def find_ppp_matches_by_em(self, em_name: str):
        from ..model.entities import PPPMatchEntity
        docs = list(self.ppp_matches.find({"sourceEmName": em_name}))
        docs.sort(key=lambda d: d.get("rank") or 0)
        out = []
        for d in docs:
            d = dict(d)
            d.pop("_id", None)
            out.append(PPPMatchEntity.from_dict(d))
        return out

    # --- PPPmURLs DAO (PPPmURLs.java, collection "pppmURL"; keyed by
    # PPP match entity id, read at EMPPPMatchesExporter.java:177-182) ---

    def upsert_pppm_urls(self, docs: Sequence[dict]) -> int:
        n = 0
        for d in docs:
            mid = d.get("_id", d.get("id"))
            if mid is None:
                continue
            doc = dict(d)
            doc["_id"] = str(mid)
            self.pppm_urls.replace_one({"_id": str(mid)}, doc, upsert=True)
            n += 1
        return n

    def find_pppm_urls_by_ids(self, match_ids):
        ids = [str(i) for i in match_ids if i is not None]
        if not ids:
            return {}
        return {str(d["_id"]): dict(d)
                for d in self.pppm_urls.find({"_id": {"$in": ids}})}

    # --- field-update handlers (MongoDaoHelper.java:255-295) ---

    @staticmethod
    def _translate_field_updates(updates: dict, allow_upsert: bool):
        """Handler -> native update-operator translation: set->$set,
        unset->$unset, append->$addToSet/$push (+$each),
        remove->$pull/$pullAll, inc->$inc,
        set_on_create->$setOnInsert (with upsert)."""
        mongo_update: dict = {}
        upsert = False
        for field, u in updates.items():
            if u.op == "set":
                mongo_update.setdefault("$set", {})[field] = u.value
            elif u.op == "unset":
                mongo_update.setdefault("$unset", {})[field] = ""
            elif u.op == "set_on_create":
                mongo_update.setdefault("$setOnInsert", {})[field] = u.value
                upsert = allow_upsert
            elif u.op == "inc":
                mongo_update.setdefault("$inc", {})[field] = u.value
            elif u.op == "append":
                if isinstance(u.value, (list, set, tuple)):
                    vals = (sorted(u.value) if isinstance(u.value, set)
                            else list(u.value))
                    key = ("$addToSet"
                           if u.add_to_set or isinstance(u.value, set)
                           else "$push")
                    mongo_update.setdefault(key, {})[field] = {"$each": vals}
                else:
                    key = "$addToSet" if u.add_to_set else "$push"
                    mongo_update.setdefault(key, {})[field] = u.value
            elif u.op == "remove":
                if isinstance(u.value, (list, set, tuple)):
                    vals = (sorted(u.value) if isinstance(u.value, set)
                            else list(u.value))
                    mongo_update.setdefault("$pullAll", {})[field] = vals
                else:
                    mongo_update.setdefault("$pull", {})[field] = u.value
            else:
                raise ValueError(f"unknown field-update op {u.op!r}")
        return mongo_update, upsert

    def update_entity_fields(self, kind: str, entity_id: int,
                             updates: dict) -> bool:
        coll = {"neurons": self.neurons, "matches": self.matches}[kind]
        mongo_update, upsert = self._translate_field_updates(
            updates, allow_upsert=kind == "neurons")
        if not upsert:
            existing = next(iter(coll.find({"_id": entity_id})), None)
            if existing is None:
                return False
        coll.update_one({"_id": entity_id}, mongo_update, upsert=upsert)
        return True

    def update_matches_fields_by_refs(self, mask_refs=None,
                                      matched_refs=None,
                                      updates: dict = None) -> int:
        """Server-side bulk match update by mask/target image refs —
        the reference's NeuronMatchesDao.updateAll with a
        NeuronsMatchFilter (ValidateNBDBDataCmd.java:355-369): ONE
        update_many carries the operators, no match docs cross the
        wire."""
        ors = []
        if mask_refs:
            ors.append({"maskImageRefId": {"$in": list(mask_refs)}})
        if matched_refs:
            ors.append({"matchedImageRefId": {"$in": list(matched_refs)}})
        if not ors or not updates:
            return 0
        query = ors[0] if len(ors) == 1 else {"$or": ors}
        mongo_update, _ = self._translate_field_updates(
            updates, allow_upsert=False)
        r = self.matches.update_many(query, mongo_update)
        return int(getattr(r, "modified_count", 0))

    # --- published-data DAOs (PublishedURLsDao / PublishedLMImageDao,
    # dao/DaosProvider.java:82-88) ---

    def upsert_published_urls(self, docs: Sequence[dict]) -> int:
        n = 0
        for d in docs:
            nid = d.get("_id", d.get("id"))
            if nid is None:
                continue
            doc = dict(d)
            doc["_id"] = nid
            self.published_urls.replace_one({"_id": nid}, doc, upsert=True)
            n += 1
        return n

    def load_published_urls(self) -> dict:
        return {str(d["_id"]): (d.get("uploaded") or {})
                for d in self.published_urls.find({}) if "_id" in d}

    def upsert_published_lm_images(self, docs: Sequence[dict]) -> int:
        n = 0
        for d in docs:
            key = {"sampleRef": d.get("sampleRef"),
                   "slideCode": d.get("slideCode") or d.get("id"),
                   "objective": d.get("objective"),
                   "alignmentSpace": d.get("alignmentSpace")}
            doc = dict(d)
            doc.update({k: v for k, v in key.items() if v is not None})
            # natural-key upsert with an explicit _id (replace docs keep
            # the existing _id; inserts mint one — stays inside the
            # certified find/replace_one fake surface)
            existing = next(iter(self.published_lm_images.find(key)), None)
            doc["_id"] = (existing["_id"] if existing is not None
                          else self.id_generator.generate_id())
            self.published_lm_images.replace_one(key, doc, upsert=True)
            n += 1
        return n

    def find_published_lm_images(self, sample_refs=None, slide_codes=None,
                                 alignment_space=None, objective=None
                                 ) -> List[dict]:
        query = {}
        if sample_refs:
            query["sampleRef"] = {"$in": list(sample_refs)}
        if slide_codes:
            query["slideCode"] = {"$in": list(slide_codes)}
        if alignment_space:
            query["alignmentSpace"] = alignment_space
        if objective:
            query["objective"] = objective
        out = []
        for d in self.published_lm_images.find(query):
            d = dict(d)
            d.pop("_id", None)
            out.append(d)
        return out

    def load_published_lm_stacks(self) -> dict:
        out = {}
        for d in self.find_published_lm_images():
            key = d.get("slideCode") or d.get("id")
            if key is not None:
                out[str(key)] = d.get("files") or {}
        return out

    # --- matches DAO ---

    def _existing_by_pair(self, matches):
        """Prefetch existing match docs keyed on (maskRef, matchedRef)
        with ONE indexed query per chunk instead of one find per match."""
        mask_refs = sorted({m.mask_ref() for m in matches
                            if m.mask_ref() is not None})
        existing = {}
        for i in range(0, len(mask_refs), _BULK_CHUNK):
            for d in self.matches.find({"maskImageRefId": {
                    "$in": mask_refs[i:i + _BULK_CHUNK]}}):
                existing[(d.get("maskImageRefId"),
                          d.get("matchedImageRefId"))] = d
        return existing

    def upsert_matches(self, matches: Sequence[CDMatchEntity],
                       update_scores_only: bool = False) -> int:
        """Bulk upsert keyed on (maskImageRefId, matchedImageRefId) —
        one bulk_write round trip per _BULK_CHUNK matches
        (AbstractNeuronMatchesMongoDao.createOrUpdateAll:117+)."""
        UpdateOne, ReplaceOne = _op_classes()
        existing = self._existing_by_pair(matches)
        ops, n = [], 0
        for m in matches:
            mask_ref = m.mask_ref()
            matched_ref = m.matched_ref()
            if mask_ref is None or matched_ref is None:
                continue
            key = {"maskImageRefId": mask_ref, "matchedImageRefId": matched_ref}
            ex = existing.get((mask_ref, matched_ref))
            if ex is not None and update_scores_only:
                # re-run mode: refresh pixel scores, keep shape scores
                # (AbstractNeuronMatchesMongoDao field updates)
                m.entity_id = ex["_id"]
                ops.append(UpdateOne({"_id": ex["_id"]}, {"$set": {
                    "matchingPixels": m.matching_pixels,
                    "matchingPixelsRatio": m.matching_pixels_ratio,
                    "mirrored": m.mirrored}}))
                n += 1
                continue
            if ex is not None:
                m.entity_id = ex["_id"]
            elif m.entity_id is None:
                m.entity_id = self.id_generator.generate_id()
            doc = m.to_dict()
            doc["_id"] = m.entity_id
            doc["maskImageRefId"] = mask_ref
            doc["matchedImageRefId"] = matched_ref
            ops.append(ReplaceOne(key, doc, upsert=True))
            n += 1
        self._bulk(self.matches, ops)
        return n

    def _bulk(self, collection, ops):
        for i in range(0, len(ops), _BULK_CHUNK):
            collection.bulk_write(ops[i:i + _BULK_CHUNK], ordered=False)

    def update_match_fields(self, matches: Sequence[CDMatchEntity],
                            fields: Sequence[str]) -> int:
        getter = {
            "normalizedScore": lambda m: m.normalized_score,
            "gradientAreaGap": lambda m: m.gradient_area_gap,
            "highExpressionArea": lambda m: m.high_expression_area,
            "bidirectionalAreaGap": lambda m: m.bidirectional_area_gap,
            "matchingPixels": lambda m: m.matching_pixels,
            "matchingPixelsRatio": lambda m: m.matching_pixels_ratio,
        }
        names = [f for f in fields if f in _MATCH_SCORE_FIELDS]
        if not names:
            return 0
        UpdateOne, _ = _op_classes()
        ops = []
        for m in matches:
            if m.entity_id is None:
                continue
            update = {f: getter[f](m) for f in names}
            ops.append(UpdateOne({"_id": m.entity_id}, {"$set": update}))
        self._bulk(self.matches, ops)
        return len(ops)

    def find_matches_by_mask_refs(self, mask_refs: Sequence[int],
                                  target_selector=None, scores_filter=None
                                  ) -> List[CDMatchEntity]:
        query = {"maskImageRefId": {"$in": list(mask_refs)}}
        clauses = selector_pushdown_clauses("image", target_selector) \
            + scores_pushdown_clauses(scores_filter)
        if clauses:
            query = {"$and": [query] + clauses}
        docs = list(self.matches.find(query))
        docs.sort(key=lambda d: -(d.get("matchingPixels") or 0))
        out = []
        for d in docs:
            d = dict(d)
            d.pop("_id", None)
            d.pop("maskImageRefId", None)
            d.pop("matchedImageRefId", None)
            out.append(CDMatchEntity.from_dict(d))
        return out

    def find_dangling_match_refs(self) -> List[tuple]:
        """(mask_ref, matched_ref) pairs whose neuron rows are gone
        (validateDBData dangling-reference scan)."""
        mask_refs = set(self.matches.distinct("maskImageRefId"))
        matched_refs = set(self.matches.distinct("matchedImageRefId"))
        known = {d["_id"] for d in self.neurons.find(
            {"_id": {"$in": sorted(mask_refs | matched_refs)}})}
        out = []
        for d in self.matches.find({}):
            mr, tr = d.get("maskImageRefId"), d.get("matchedImageRefId")
            if mr not in known or tr not in known:
                out.append((mr, tr))
        return sorted(out)

    def distinct_target_mip_ids_with_matches(self) -> List[str]:
        refs = set(self.matches.distinct("matchedImageRefId"))
        if not refs:
            return []
        mips = set()
        for d in self.neurons.find({"_id": {"$in": sorted(refs)}}):
            if d.get("mipId"):
                mips.add(d["mipId"])
        return sorted(mips)

    def find_matches_by_matched_refs(self, matched_refs: Sequence[int],
                                     mask_selector=None, scores_filter=None
                                     ) -> List[CDMatchEntity]:
        query = {"matchedImageRefId": {"$in": list(matched_refs)}}
        clauses = selector_pushdown_clauses("maskImage", mask_selector) \
            + scores_pushdown_clauses(scores_filter)
        if clauses:
            query = {"$and": [query] + clauses}
        docs = list(self.matches.find(query))
        docs.sort(key=lambda d: -(d.get("matchingPixels") or 0))
        out = []
        for d in docs:
            d = dict(d)
            d.pop("_id", None)
            d.pop("maskImageRefId", None)
            d.pop("matchedImageRefId", None)
            out.append(CDMatchEntity.from_dict(d))
        return out

    def distinct_mask_mip_ids_with_matches(self) -> List[str]:
        refs = set(self.matches.distinct("maskImageRefId"))
        if not refs:
            return []
        mips = set()
        for d in self.neurons.find({"_id": {"$in": sorted(refs)}}):
            if d.get("mipId"):
                mips.add(d["mipId"])
        return sorted(mips)

    def delete_matches(self, mask_refs: Optional[Sequence[int]] = None,
                       max_pixels: Optional[int] = None) -> int:
        query = {}
        if mask_refs:
            query["maskImageRefId"] = {"$in": list(mask_refs)}
        if max_pixels is not None:
            query["matchingPixels"] = {"$lt": max_pixels}
        res = self.matches.delete_many(query)
        return getattr(res, "deleted_count", 0)

    def delete_matches_by_ids(self, entity_ids: Sequence[int],
                              archive: bool = True) -> int:
        """Delete matches by entity id; the full docs go to the
        cdMatchesArchive collection first unless archive=False
        (AbstractNeuronMatchesMongoDao.archiveEntityIds + the
        DBNeuronMatchesRemover archive-on-delete default). Uses only the
        documented pymongo surface (replace_one/delete_many), not the
        reference's $merge aggregation, for the same end state."""
        if not entity_ids:
            return 0
        ids = list(entity_ids)
        if archive:
            _, ReplaceOne = _op_classes()
            arch = self._db["cdMatchesArchive"]
            self._bulk(arch, [ReplaceOne({"_id": d["_id"]}, d, upsert=True)
                              for d in self.matches.find(
                                  {"_id": {"$in": ids}})])
        res = self.matches.delete_many({"_id": {"$in": ids}})
        return getattr(res, "deleted_count", 0)

    def archived_match_ids(self) -> List[int]:
        return [d["_id"] for d in self._db["cdMatchesArchive"].find({})]


def open_store(db_arg: str):
    """Open the right backend for a --db argument: a mongodb:// URI gets
    the Mongo store, anything else the embedded SQLite store (the
    reference is Mongo-only, DaosProvider.java; the SQLite embedded
    backend is this framework's self-contained default)."""
    if db_arg.startswith("mongodb://") or db_arg.startswith("mongodb+srv://"):
        return MongoStore(db_arg)
    from .db import SqliteStore
    return SqliteStore(db_arg)
