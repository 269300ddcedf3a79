"""Database persistence backends (SQLite).

Copy of `colormipsearch_tpu/dataio/db.py`.

Counterpart of the reference's Mongo DAO layer (colormipsearch-persist
dao/mongo/*.java and dataio/db/*.java), implemented over SQLite so the
framework ships with a real embedded database while keeping the same
reader/writer interfaces (a Mongo backend can slot in behind the same
split). Semantics preserved:

- neuron metadata store keyed by entityId with secondary indexes on
  mipId / libraryName / publishedName
  (NeuronMetadataMongoDao.java:68-76)
- match upserts keyed on (maskImageRefId, matchedImageRefId)
  (AbstractNeuronMatchesMongoDao.createOrUpdateAll,
  AbstractNeuronMatchesMongoDao.java:117+), with score-only field
  updates for re-runs
- listMatchesLocations = distinct mask mip ids having matches
  (DBNeuronMatchesReader.java:42-64)
"""

from __future__ import annotations

import json
import os
import sqlite3
import threading
from typing import Dict, List, Optional, Sequence, Set

from ..model.entities import CDMatchEntity, NeuronEntity, entity_from_dict
from ..model.enums import ProcessingType
from ..persist.idgenerator import TimebasedIdGenerator
from .base import (CDMIPsReader, CDMIPsWriter, DataSourceParam,
                   NeuronMatchesReader, NeuronMatchesWriter, ScoresFilter,
                   SortCriteria)

_SCHEMA = """
CREATE TABLE IF NOT EXISTS neuron_metadata (
    entity_id INTEGER PRIMARY KEY,
    mip_id TEXT, alignment_space TEXT, library_name TEXT,
    published_name TEXT, doc TEXT NOT NULL);
CREATE INDEX IF NOT EXISTS idx_nm_mip ON neuron_metadata(mip_id);
CREATE INDEX IF NOT EXISTS idx_nm_lib ON neuron_metadata(library_name);
CREATE INDEX IF NOT EXISTS idx_nm_pub ON neuron_metadata(published_name);

CREATE TABLE IF NOT EXISTS cd_matches (
    entity_id INTEGER PRIMARY KEY,
    mask_ref INTEGER NOT NULL, matched_ref INTEGER NOT NULL,
    matching_pixels INTEGER, matching_pixels_ratio REAL,
    normalized_score REAL, gradient_area_gap INTEGER,
    high_expression_area INTEGER, bidirectional_area_gap INTEGER,
    mirrored INTEGER, session_ref TEXT, doc TEXT NOT NULL,
    UNIQUE(mask_ref, matched_ref));
CREATE INDEX IF NOT EXISTS idx_cm_mask ON cd_matches(mask_ref);
CREATE INDEX IF NOT EXISTS idx_cm_matched ON cd_matches(matched_ref);

-- deleted matches are archived here by default, mirroring the Mongo
-- archive collection (AbstractNeuronMatchesMongoDao.archiveEntityIds)
CREATE TABLE IF NOT EXISTS cd_matches_archive (
    entity_id INTEGER PRIMARY KEY, doc TEXT NOT NULL);

CREATE TABLE IF NOT EXISTS cd_sessions (
    entity_id INTEGER PRIMARY KEY, doc TEXT NOT NULL);

CREATE TABLE IF NOT EXISTS ppp_matches (
    entity_id INTEGER PRIMARY KEY,
    em_name TEXT NOT NULL, lm_name TEXT NOT NULL,
    rank REAL, doc TEXT NOT NULL,
    UNIQUE(em_name, lm_name));
CREATE INDEX IF NOT EXISTS idx_ppp_em ON ppp_matches(em_name);

-- published-data stores (PublishedURLsDao / PublishedLMImageDao wired
-- at dao/DaosProvider.java:82-88; store names "publishedURL" /
-- "publishedLMImage" via @PersistenceInfo). Populated by external
-- publishing pipelines in the reference; exports read them when the
-- run has a DB (files remain the offline fallback).
CREATE TABLE IF NOT EXISTS published_urls (
    neuron_id TEXT PRIMARY KEY, doc TEXT NOT NULL);

CREATE TABLE IF NOT EXISTS published_lm_images (
    row_id INTEGER PRIMARY KEY AUTOINCREMENT,
    sample_ref TEXT, slide_code TEXT, objective TEXT,
    alignment_space TEXT, doc TEXT NOT NULL,
    UNIQUE(sample_ref, slide_code, objective, alignment_space));
CREATE INDEX IF NOT EXISTS idx_pli_sample ON published_lm_images(sample_ref);
CREATE INDEX IF NOT EXISTS idx_pli_slide ON published_lm_images(slide_code);

-- per-PPP-match published screenshot URLs (PPPmURLs.java, store name
-- "pppmURL" via @PersistenceInfo; read by EMPPPMatchesExporter
-- .updateMatchedResultsMetadata:177-182 keyed by match entity id)
CREATE TABLE IF NOT EXISTS pppm_urls (
    match_id TEXT PRIMARY KEY, doc TEXT NOT NULL);
"""


_SCORE_SQL_COLS = {
    "matchingPixels": "matching_pixels",
    "matchingRatio": "matching_pixels_ratio",
    "matchingPixelsRatio": "matching_pixels_ratio",
    "gradientAreaGap": "gradient_area_gap",
    "bidirectionalAreaGap": "bidirectional_area_gap",
    "highExpressionArea": "high_expression_area",
    "normalizedScore": "normalized_score",
}


def _scores_sql(sf):
    """ScoresFilter -> SQL WHERE fragment over the indexed score columns
    (the SQLite face of the Mongo selector pushdown,
    db_mongo.scores_pushdown_clauses): per selector OR over '|'-joined
    fields >= min; -1 sentinel = every field NULL or -1."""
    if sf is None or sf.empty:
        return "", []
    clauses, params = [], []
    for field_name, min_score in sf.selectors:
        cols = [_SCORE_SQL_COLS[x] for x in field_name.split("|")
                if x in _SCORE_SQL_COLS]
        if not cols:
            continue
        if min_score == -1:
            for col in cols:
                clauses.append(f"({col} IS NULL OR {col} = -1)")
        else:
            ors = " OR ".join(f"({c} IS NOT NULL AND {c} >= ?)"
                              for c in cols)
            clauses.append(f"({ors})")
            params.extend([min_score] * len(cols))
    if not clauses:
        return "", []
    return " AND " + " AND ".join(clauses), params


class SqliteStore:
    """Shared connection + schema (DaosProvider analogue,
    dao/DaosProvider.java:23-97)."""

    def __init__(self, path: str):
        self.path = path
        if path != ":memory:":
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._conn = sqlite3.connect(path, check_same_thread=False,
                                     timeout=60.0)
        if path != ":memory:":
            # grid blocks share one store (run_full_precompute.sh):
            # WAL + busy timeout let concurrent block processes write
            # without "database is locked" failures (the reference's
            # concurrency is mediated by Mongo; this is the embedded
            # equivalent)
            self._conn.execute("PRAGMA journal_mode=WAL")
            self._conn.execute("PRAGMA busy_timeout=60000")
        self._conn.executescript(_SCHEMA)
        self._lock = threading.Lock()
        self.id_generator = TimebasedIdGenerator()

    def close(self) -> None:
        self._conn.close()

    # --- neuron metadata DAO ---

    def _resolve_neuron_identity(self, e: NeuronEntity):
        """createOrUpdate identity resolution for id-less entities
        (NeuronMetadataMongoDao.java:80-110): adopt the entity_id of an
        existing row with the same class + mipId (+ same
        InputColorDepthImage when present), so re-runs from JSON inputs
        without entityIds stay idempotent instead of duplicating."""
        if e.mip_id is None:
            return None
        d = e.to_dict()
        want_cls = d.get("class")
        want_input = (d.get("computeFiles") or {}).get("InputColorDepthImage")
        rows = self._conn.execute(
            "SELECT entity_id, doc FROM neuron_metadata WHERE mip_id = ?",
            (e.mip_id,)).fetchall()
        for eid, doc in rows:
            ex = json.loads(doc)
            if ex.get("class") != want_cls:
                continue
            ex_input = (ex.get("computeFiles") or {}).get("InputColorDepthImage")
            if want_input and ex_input and want_input != ex_input:
                continue
            return eid
        return None

    def upsert_neurons(self, entities: Sequence[NeuronEntity]) -> None:
        rows = []
        for e in entities:
            if e.entity_id is None:
                with self._lock:
                    e.entity_id = self._resolve_neuron_identity(e)
            if e.entity_id is None:
                e.entity_id = self.id_generator.generate_id()
            rows.append((e.entity_id, e.mip_id, e.alignment_space,
                         e.library_name, e.published_name,
                         json.dumps(e.to_dict())))
        with self._lock:
            self._conn.executemany(
                "INSERT INTO neuron_metadata VALUES (?,?,?,?,?,?) "
                "ON CONFLICT(entity_id) DO UPDATE SET doc=excluded.doc, "
                "mip_id=excluded.mip_id, library_name=excluded.library_name, "
                "published_name=excluded.published_name", rows)
            self._conn.commit()

    def find_neurons(self, param: DataSourceParam) -> List[NeuronEntity]:
        clauses, args = [], []
        if param.alignment_space:
            clauses.append("alignment_space = ?")
            args.append(param.alignment_space)
        if param.libraries:
            clauses.append("library_name IN (%s)"
                           % ",".join("?" * len(param.libraries)))
            args.extend(param.libraries)
        if param.mip_ids:
            clauses.append("mip_id IN (%s)" % ",".join("?" * len(param.mip_ids)))
            args.extend(param.mip_ids)
        if param.names:
            clauses.append("published_name IN (%s)"
                           % ",".join("?" * len(param.names)))
            args.extend(param.names)
        sql = "SELECT doc FROM neuron_metadata"
        if clauses:
            sql += " WHERE " + " AND ".join(clauses)
        sql += " ORDER BY entity_id"
        with self._lock:
            rows = self._conn.execute(sql, args).fetchall()
        entities = [entity_from_dict(json.loads(r[0])) for r in rows]
        # tag/dataset filters live in the JSON doc
        entities = [e for e in entities if param.matches_entity(e)]
        return param.apply_slice(entities)

    def distinct_neuron_values(self, column: str) -> List[str]:
        if column not in ("mip_id", "library_name", "published_name",
                          "alignment_space"):
            raise ValueError(column)
        with self._lock:
            rows = self._conn.execute(
                f"SELECT DISTINCT {column} FROM neuron_metadata "
                f"WHERE {column} IS NOT NULL").fetchall()
        return sorted(r[0] for r in rows)

    # --- session DAO (DBCDSSessionWriter / MatchSessionDao analogue) ---

    def create_session(self, session) -> int:
        """Persist a CDS run's parameters for provenance
        (ColorDepthSearchCmd.java:255-278)."""
        if session.entity_id is None:
            session.entity_id = self.id_generator.generate_id()
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO cd_sessions VALUES (?, ?)",
                (session.entity_id, json.dumps(session.to_dict())))
            self._conn.commit()
        return session.entity_id

    def list_sessions(self) -> List[dict]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT doc FROM cd_sessions ORDER BY entity_id").fetchall()
        return [json.loads(r[0]) for r in rows]

    # --- PPP matches DAO (pppMatches collection analogue;
    # AbstractNeuronMatchesMongoDao over PPPMatchEntity). Upserts key on
    # the stable (sourceEmName, sourceLmName) pair — PPP imports carry
    # no neuron entity ids (ImportPPPResultsCmd builds neurons from the
    # raw names), so the natural key replaces the reference's image-ref
    # key with identical idempotence semantics. ---

    def upsert_ppp_matches(self, matches) -> int:
        n = 0
        with self._lock:
            # a natural-key re-import keeps the ORIGINAL entity ids
            # (pppmURL records key on them; the reference's Mongo upsert
            # likewise never rewrites _id). One batched SELECT per call
            # — not one per row — keeps the measured ~26K matches/s
            # write path.
            ems = sorted({m.source_em_name for m in matches
                          if m.source_em_name and m.source_lm_name})
            existing = {}
            if ems:
                qs = ",".join("?" * len(ems))
                for eid, em, lm in self._conn.execute(
                        f"SELECT entity_id, em_name, lm_name FROM "
                        f"ppp_matches WHERE em_name IN ({qs})", ems):
                    existing[(em, lm)] = eid
            for m in matches:
                if not m.source_em_name or not m.source_lm_name:
                    continue
                eid = existing.get((m.source_em_name, m.source_lm_name))
                if eid is not None:
                    m.entity_id = eid
                elif m.entity_id is None:
                    m.entity_id = self.id_generator.generate_id()
                self._conn.execute(
                    "INSERT INTO ppp_matches VALUES (?,?,?,?,?) "
                    "ON CONFLICT(em_name, lm_name) DO UPDATE SET "
                    "rank=excluded.rank, doc=excluded.doc",
                    (m.entity_id, m.source_em_name, m.source_lm_name,
                     m.rank, json.dumps(m.to_dict())))
                n += 1
            self._conn.commit()
        return n

    def list_ppp_em_names(self) -> List[str]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT DISTINCT em_name FROM ppp_matches").fetchall()
        return sorted(r[0] for r in rows)

    def find_ppp_matches_by_em(self, em_name: str):
        from ..model.entities import PPPMatchEntity
        with self._lock:
            rows = self._conn.execute(
                "SELECT doc FROM ppp_matches WHERE em_name = ? "
                "ORDER BY rank", (em_name,)).fetchall()
        return [PPPMatchEntity.from_dict(json.loads(r[0])) for r in rows]

    # --- PPPmURLs DAO (dao/PublishedURLsDao.java over PPPmURLs.java,
    # store "pppmURL"): per-match published screenshot URL + thumbnail
    # maps keyed by PPP match entity id ---

    def upsert_pppm_urls(self, docs: Sequence[dict]) -> int:
        """docs: [{"_id"|"id": matchId,
        "uploadedFiles": {screenshotType: url},
        "uploadedThumbnails": {screenshotType: url}}]
        (PPPmURLs.java:11-32)."""
        n = 0
        with self._lock:
            for d in docs:
                mid = d.get("_id", d.get("id"))
                if mid is None:
                    continue
                self._conn.execute(
                    "INSERT INTO pppm_urls VALUES (?,?) "
                    "ON CONFLICT(match_id) DO UPDATE SET doc=excluded.doc",
                    (str(mid), json.dumps(d)))
                n += 1
            self._conn.commit()
        return n

    def find_pppm_urls_by_ids(self, match_ids) -> Dict[str, dict]:
        """PublishedURLsDao.findByEntityIds over the pppmURL store
        (EMPPPMatchesExporter.java:177-180)."""
        ids = [str(i) for i in match_ids if i is not None]
        if not ids:
            return {}
        qs = ",".join("?" * len(ids))
        with self._lock:
            rows = self._conn.execute(
                f"SELECT match_id, doc FROM pppm_urls WHERE match_id "
                f"IN ({qs})", ids).fetchall()
        return {mid: json.loads(doc) for mid, doc in rows}

    # --- field-update handlers (Set/Append/Remove/Inc/SetOnCreate,
    # dao/AbstractMongoDao.update + MongoDaoHelper.java:255-295) ---

    _NEURON_COLS = (("mip_id", "mipId"), ("alignment_space", "alignmentSpace"),
                    ("library_name", "libraryName"),
                    ("published_name", "publishedName"))
    _MATCH_COLS = (("matching_pixels", "matchingPixels"),
                   ("matching_pixels_ratio", "matchingPixelsRatio"),
                   ("normalized_score", "normalizedScore"),
                   ("gradient_area_gap", "gradientAreaGap"),
                   ("high_expression_area", "highExpressionArea"),
                   ("bidirectional_area_gap", "bidirectionalAreaGap"))

    def update_entity_fields(self, kind: str, entity_id: int,
                             updates: dict) -> bool:
        """Apply field-update handlers server-side (no read-modify-write
        round trip through entity objects). kind: "neurons"|"matches".
        Returns False when the row is absent and no set_on_create
        handler asks for creation."""
        from .base import apply_field_updates
        table = {"neurons": "neuron_metadata",
                 "matches": "cd_matches"}[kind]
        cols = self._NEURON_COLS if kind == "neurons" else self._MATCH_COLS
        with self._lock:
            row = self._conn.execute(
                f"SELECT doc FROM {table} WHERE entity_id = ?",
                (entity_id,)).fetchone()
            created = row is None
            if created and not any(u.op == "set_on_create"
                                   for u in updates.values()):
                return False
            doc = json.loads(row[0]) if row else {"id": str(entity_id)}
            apply_field_updates(doc, updates, created)
            col_sets = ", ".join(f"{c} = ?" for c, _ in cols)
            vals = [doc.get(k) for _, k in cols]
            if created:
                if kind == "matches":
                    # matches need mask/matched refs; field-handler
                    # creation is a neuron-side flow in the reference
                    return False
                self._conn.execute(
                    f"INSERT INTO {table} (entity_id, "
                    + ", ".join(c for c, _ in cols)
                    + ", doc) VALUES (?" + ",?" * len(cols) + ",?)",
                    [entity_id] + vals + [json.dumps(doc)])
            else:
                self._conn.execute(
                    f"UPDATE {table} SET {col_sets}, doc = ? "
                    "WHERE entity_id = ?",
                    vals + [json.dumps(doc), entity_id])
            self._conn.commit()
        return True

    def update_matches_fields_by_refs(self, mask_refs=None,
                                      matched_refs=None,
                                      updates: dict = None) -> int:
        """Bulk match field updates by mask/target refs (the Mongo
        store does this with one server-side update_many; here indexed
        id selection + per-row handler application)."""
        if not updates:
            return 0
        ids = set()
        with self._lock:
            if mask_refs:
                qs = ",".join("?" * len(mask_refs))
                ids.update(r[0] for r in self._conn.execute(
                    f"SELECT entity_id FROM cd_matches WHERE mask_ref "
                    f"IN ({qs})", list(mask_refs)))
            if matched_refs:
                qs = ",".join("?" * len(matched_refs))
                ids.update(r[0] for r in self._conn.execute(
                    f"SELECT entity_id FROM cd_matches WHERE matched_ref "
                    f"IN ({qs})", list(matched_refs)))
        return sum(1 for i in sorted(ids)
                   if self.update_entity_fields("matches", i, updates))

    # --- published-data DAOs (PublishedURLsDao / PublishedLMImageDao,
    # dao/DaosProvider.java:82-88). Doc shapes match the JSON-file
    # fallback (cmd/dataexport.py load_published_urls /
    # load_published_lm_stacks) so either source feeds the export. ---

    def upsert_published_urls(self, docs: Sequence[dict]) -> int:
        """docs: [{"_id"|"id": neuronId, "uploaded": {key: url}}]
        (NeuronPublishedURLs.java:9-15, keyed by neuron entity id)."""
        n = 0
        with self._lock:
            for d in docs:
                nid = d.get("_id", d.get("id"))
                if nid is None:
                    continue
                self._conn.execute(
                    "INSERT INTO published_urls VALUES (?,?) "
                    "ON CONFLICT(neuron_id) DO UPDATE SET doc=excluded.doc",
                    (str(nid), json.dumps(d)))
                n += 1
            self._conn.commit()
        return n

    def load_published_urls(self) -> dict:
        """neuronId -> uploaded-URL map for every stored record."""
        with self._lock:
            rows = self._conn.execute(
                "SELECT neuron_id, doc FROM published_urls").fetchall()
        return {nid: (json.loads(doc).get("uploaded") or {})
                for nid, doc in rows}

    def upsert_published_lm_images(self, docs: Sequence[dict]) -> int:
        """docs carry PublishedLMImageFields (sampleRef, slideCode,
        objective, alignmentSpace, files, gal4...; PublishedLMImage
        .java:12-41); natural-keyed on the identifying quadruple."""
        n = 0
        with self._lock:
            for d in docs:
                self._conn.execute(
                    "INSERT INTO published_lm_images "
                    "(sample_ref, slide_code, objective, alignment_space,"
                    " doc) VALUES (?,?,?,?,?) "
                    "ON CONFLICT(sample_ref, slide_code, objective, "
                    "alignment_space) DO UPDATE SET doc=excluded.doc",
                    (d.get("sampleRef"), d.get("slideCode") or d.get("id"),
                     d.get("objective"), d.get("alignmentSpace"),
                     json.dumps(d)))
                n += 1
            self._conn.commit()
        return n

    def find_published_lm_images(self, sample_refs=None, slide_codes=None,
                                 alignment_space=None, objective=None
                                 ) -> List[dict]:
        """getPublishedImages-style selector
        (dao/PublishedLMImageDao.java:11-47): optional alignmentSpace /
        objective filters over indexed sampleRef/slideCode lookups."""
        clauses, params = [], []
        if sample_refs:
            refs = list(sample_refs)
            clauses.append("sample_ref IN (%s)" % ",".join("?" * len(refs)))
            params.extend(refs)
        if slide_codes:
            codes = list(slide_codes)
            clauses.append("slide_code IN (%s)" % ",".join("?" * len(codes)))
            params.extend(codes)
        if alignment_space:
            clauses.append("alignment_space = ?")
            params.append(alignment_space)
        if objective:
            clauses.append("objective = ?")
            params.append(objective)
        sql = "SELECT doc FROM published_lm_images"
        if clauses:
            sql += " WHERE " + " AND ".join(clauses)
        with self._lock:
            rows = self._conn.execute(sql, params).fetchall()
        return [json.loads(r[0]) for r in rows]

    def load_published_lm_stacks(self) -> dict:
        """slideCode -> files map (the export consumption shape,
        ColorDepthMIP.updateLMNeuron:220-221)."""
        out = {}
        for d in self.find_published_lm_images():
            key = d.get("slideCode") or d.get("id")
            if key is not None:
                out[str(key)] = d.get("files") or {}
        return out

    # --- matches DAO ---

    def upsert_matches(self, matches: Sequence[CDMatchEntity],
                       update_scores_only: bool = False) -> int:
        """createOrUpdateAll keyed on (mask_ref, matched_ref).

        update_scores_only=True is the re-run mode
        (ColorDepthSearchCmd.java:395-401 with --update-matches): an
        existing match keeps its gradient/high-expression/normalized
        fields and only the pixel-match scores are refreshed, so a CDS
        re-run never clobbers a completed gradientScores pass."""
        n = 0
        with self._lock:
            for m in matches:
                mask_ref = m.mask_ref()
                matched_ref = m.matched_ref()
                if mask_ref is None or matched_ref is None:
                    continue
                if update_scores_only:
                    row = self._conn.execute(
                        "SELECT entity_id, doc FROM cd_matches WHERE "
                        "mask_ref = ? AND matched_ref = ?",
                        (mask_ref, matched_ref)).fetchone()
                    if row is not None:
                        doc = json.loads(row[1])
                        doc["matchingPixels"] = m.matching_pixels
                        doc["matchingPixelsRatio"] = m.matching_pixels_ratio
                        doc["mirrored"] = m.mirrored
                        self._conn.execute(
                            "UPDATE cd_matches SET matching_pixels = ?, "
                            "matching_pixels_ratio = ?, mirrored = ?, "
                            "doc = ? WHERE entity_id = ?",
                            (m.matching_pixels, m.matching_pixels_ratio,
                             1 if m.mirrored else 0, json.dumps(doc),
                             row[0]))
                        m.entity_id = row[0]
                        n += 1
                        continue
                if m.entity_id is None:
                    m.entity_id = self.id_generator.generate_id()
                self._conn.execute(
                    "INSERT INTO cd_matches VALUES (?,?,?,?,?,?,?,?,?,?,?,?) "
                    "ON CONFLICT(mask_ref, matched_ref) DO UPDATE SET "
                    "matching_pixels=excluded.matching_pixels, "
                    "matching_pixels_ratio=excluded.matching_pixels_ratio, "
                    "normalized_score=excluded.normalized_score, "
                    "gradient_area_gap=excluded.gradient_area_gap, "
                    "high_expression_area=excluded.high_expression_area, "
                    "bidirectional_area_gap=excluded.bidirectional_area_gap, "
                    "mirrored=excluded.mirrored, doc=excluded.doc",
                    (m.entity_id, mask_ref, matched_ref,
                     m.matching_pixels, m.matching_pixels_ratio,
                     m.normalized_score, m.gradient_area_gap,
                     m.high_expression_area, m.bidirectional_area_gap,
                     1 if m.mirrored else 0, m.session_ref_id,
                     json.dumps(m.to_dict())))
                n += 1
            self._conn.commit()
        return n

    def update_match_fields(self, matches: Sequence[CDMatchEntity],
                            fields: Sequence[str]) -> int:
        """Field-level bulk updates (DBCDScoresOnlyWriter semantics)."""
        col_map = {"normalizedScore": "normalized_score",
                   "gradientAreaGap": "gradient_area_gap",
                   "highExpressionArea": "high_expression_area",
                   "bidirectionalAreaGap": "bidirectional_area_gap",
                   "matchingPixels": "matching_pixels",
                   "matchingPixelsRatio": "matching_pixels_ratio"}
        getter = {"normalizedScore": lambda m: m.normalized_score,
                  "gradientAreaGap": lambda m: m.gradient_area_gap,
                  "highExpressionArea": lambda m: m.high_expression_area,
                  "bidirectionalAreaGap": lambda m: m.bidirectional_area_gap,
                  "matchingPixels": lambda m: m.matching_pixels,
                  "matchingPixelsRatio": lambda m: m.matching_pixels_ratio}
        cols = [col_map[f] for f in fields if f in col_map]
        if not cols:
            return 0
        n = 0
        with self._lock:
            for m in matches:
                if m.entity_id is None:
                    continue
                sets = ", ".join(f"{c} = ?" for c in cols)
                vals = [getter[f](m) for f in fields if f in col_map]
                self._conn.execute(
                    f"UPDATE cd_matches SET {sets}, doc = ? WHERE entity_id = ?",
                    vals + [json.dumps(m.to_dict()), m.entity_id])
                n += 1
            self._conn.commit()
        return n

    def find_matches_by_mask_refs(self, mask_refs: Sequence[int],
                                  target_selector=None, scores_filter=None
                                  ) -> List[CDMatchEntity]:
        qs = ",".join("?" * len(mask_refs))
        where, params = _scores_sql(scores_filter)
        with self._lock:
            rows = self._conn.execute(
                f"SELECT doc FROM cd_matches WHERE mask_ref IN ({qs})"
                f"{where} ORDER BY matching_pixels DESC",
                list(mask_refs) + params).fetchall()
        matches = [CDMatchEntity.from_dict(json.loads(r[0])) for r in rows]
        if target_selector is not None:
            matches = [m for m in matches
                       if m.matched_image is None
                       or target_selector.matches_entity(m.matched_image)]
        return matches

    def find_dangling_match_refs(self) -> List[tuple]:
        """(mask_ref, matched_ref) of matches whose mask or target no
        longer resolves to a neuron row (validateDBData's dangling-
        reference scan; an SQL anti-join, so 100k+-row stores never
        load wholesale)."""
        with self._lock:
            rows = self._conn.execute(
                "SELECT m.mask_ref, m.matched_ref FROM cd_matches m "
                "LEFT JOIN neuron_metadata a ON a.entity_id = m.mask_ref "
                "LEFT JOIN neuron_metadata b ON b.entity_id = m.matched_ref "
                "WHERE a.entity_id IS NULL OR b.entity_id IS NULL "
                "ORDER BY m.mask_ref, m.matched_ref").fetchall()
        return [(r[0], r[1]) for r in rows]

    def distinct_mask_mip_ids_with_matches(self) -> List[str]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT DISTINCT n.mip_id FROM cd_matches c "
                "JOIN neuron_metadata n ON n.entity_id = c.mask_ref "
                "WHERE n.mip_id IS NOT NULL").fetchall()
        return sorted(r[0] for r in rows)

    def distinct_target_mip_ids_with_matches(self) -> List[str]:
        """Distinct matched (target) mip ids — the LM-side export axis
        (LMCDMatchesExporter / NeuronMatchesReader.listMatchesLocations
        by target)."""
        with self._lock:
            rows = self._conn.execute(
                "SELECT DISTINCT n.mip_id FROM cd_matches c "
                "JOIN neuron_metadata n ON n.entity_id = c.matched_ref "
                "WHERE n.mip_id IS NOT NULL").fetchall()
        return sorted(r[0] for r in rows)

    def find_matches_by_matched_refs(self, matched_refs: Sequence[int],
                                     mask_selector=None, scores_filter=None
                                     ) -> List[CDMatchEntity]:
        qs = ",".join("?" * len(matched_refs))
        where, params = _scores_sql(scores_filter)
        with self._lock:
            rows = self._conn.execute(
                f"SELECT doc FROM cd_matches WHERE matched_ref IN ({qs})"
                f"{where} ORDER BY matching_pixels DESC",
                list(matched_refs) + params).fetchall()
        matches = [CDMatchEntity.from_dict(json.loads(r[0])) for r in rows]
        if mask_selector is not None:
            matches = [m for m in matches
                       if m.mask_image is None
                       or mask_selector.matches_entity(m.mask_image)]
        return matches

    def delete_matches(self, mask_refs: Optional[Sequence[int]] = None,
                       max_pixels: Optional[int] = None) -> int:
        clauses, args = [], []
        if mask_refs:
            clauses.append("mask_ref IN (%s)" % ",".join("?" * len(mask_refs)))
            args.extend(mask_refs)
        if max_pixels is not None:
            clauses.append("matching_pixels < ?")
            args.append(max_pixels)
        sql = "DELETE FROM cd_matches"
        if clauses:
            sql += " WHERE " + " AND ".join(clauses)
        with self._lock:
            cur = self._conn.execute(sql, args)
            self._conn.commit()
        return cur.rowcount

    def delete_matches_by_ids(self, entity_ids: Sequence[int],
                              archive: bool = True) -> int:
        """Delete matches by entity id, copying the full docs into
        cd_matches_archive first unless archive=False
        (DBNeuronMatchesRemover.delete + archiveEntityIds,
        dao/mongo/AbstractNeuronMatchesMongoDao.java:359-384)."""
        if not entity_ids:
            return 0
        n = 0
        with self._lock:
            for i in range(0, len(entity_ids), 500):
                chunk = list(entity_ids[i:i + 500])
                ph = ",".join("?" * len(chunk))
                if archive:
                    self._conn.execute(
                        "INSERT OR REPLACE INTO cd_matches_archive "
                        "(entity_id, doc) SELECT entity_id, doc FROM "
                        f"cd_matches WHERE entity_id IN ({ph})", chunk)
                cur = self._conn.execute(
                    f"DELETE FROM cd_matches WHERE entity_id IN ({ph})",
                    chunk)
                n += cur.rowcount
            self._conn.commit()
        return n

    def archived_match_ids(self) -> List[int]:
        with self._lock:
            return [r[0] for r in self._conn.execute(
                "SELECT entity_id FROM cd_matches_archive")]


class DBCDMIPsReader(CDMIPsReader):
    def __init__(self, store: SqliteStore):
        self.store = store

    def read_mips(self, param: DataSourceParam) -> List[NeuronEntity]:
        return self.store.find_neurons(param)


class DBCDMIPsWriter(CDMIPsWriter):
    """Upsert-if-exists writer (DBCheckedCDMIPsWriter analogue)."""

    def __init__(self, store: SqliteStore):
        self.store = store

    def open(self) -> None:
        pass

    def write(self, entities: List[NeuronEntity]) -> None:
        self.store.upsert_neurons(entities)

    def add_processing_tags(self, entities: List[NeuronEntity],
                            processing_type: ProcessingType,
                            tags: Set[str]) -> None:
        for e in entities:
            for t in tags:
                e.add_processed_tag(processing_type, t)
        self.store.upsert_neurons(entities)

    def close(self) -> None:
        pass


class DBNeuronMatchesReader(NeuronMatchesReader):
    def __init__(self, store: SqliteStore):
        self.store = store

    def list_match_locations(self, params: List[DataSourceParam]) -> List[str]:
        mips = self.store.distinct_mask_mip_ids_with_matches()
        out = []
        for p in params or [DataSourceParam()]:
            if p.mip_ids:
                out.extend(m for m in mips if m in set(p.mip_ids))
            else:
                out.extend(mips)
        return sorted(set(out))

    def read_matches_by_mask(self, mask_selector: DataSourceParam,
                             target_selector: Optional[DataSourceParam] = None,
                             scores_filter: Optional[ScoresFilter] = None,
                             sort: Optional[SortCriteria] = None
                             ) -> List[CDMatchEntity]:
        """Selectors and score filters are pushed DOWN to the store
        (server-side find operators on Mongo, indexed SQL columns on
        SQLite — VERDICT r3 #5): a mask's full match set never crosses
        the wire just to be filtered in Python."""
        masks = self.store.find_neurons(mask_selector)
        refs = [e.entity_id for e in masks if e.entity_id is not None]
        if not refs:
            return []
        return self.store.find_matches_by_mask_refs(
            refs, target_selector=target_selector,
            scores_filter=scores_filter)

    def list_target_locations(self, params: List[DataSourceParam]
                              ) -> List[str]:
        mips = self.store.distinct_target_mip_ids_with_matches()
        out = []
        for p in params or [DataSourceParam()]:
            if p.mip_ids:
                out.extend(m for m in mips if m in set(p.mip_ids))
            else:
                out.extend(mips)
        return sorted(set(out))

    def read_matches_by_target(self, target_selector: DataSourceParam,
                               mask_selector=None, scores_filter=None
                               ) -> List[CDMatchEntity]:
        """Indexed matched-side read
        (DBNeuronMatchesReader.readMatchesByTarget)."""
        targets = self.store.find_neurons(target_selector)
        refs = [e.entity_id for e in targets if e.entity_id is not None]
        if not refs:
            return []
        return self.store.find_matches_by_matched_refs(
            refs, mask_selector=mask_selector, scores_filter=scores_filter)


class DBNeuronMatchesWriter(NeuronMatchesWriter):
    def __init__(self, store: SqliteStore, update_scores_only: bool = False):
        self.store = store
        self.update_scores_only = update_scores_only

    def write(self, matches: List[CDMatchEntity]) -> int:
        # ensure images are persisted so refs resolve
        neurons = {}
        for m in matches:
            for e in (m.mask_image, m.matched_image):
                if e is not None:
                    key = e.entity_id or id(e)
                    neurons[key] = e
        self.store.upsert_neurons(list(neurons.values()))
        return self.store.upsert_matches(
            matches, update_scores_only=self.update_scores_only)

    def write_updates(self, matches: List[CDMatchEntity],
                      fields: List[str]) -> int:
        return self.store.update_match_fields(matches, fields)
