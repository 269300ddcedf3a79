"""tag command: bulk add/remove tags on neuron metadata
(cmd/TagNeuronMetadataCmd.java:20-121), with the NeuronSelector
selection surface (dao/NeuronSelector.java) and paged store reads so
100k+-neuron stores never load wholesale.

Copy of `colormipsearch_tpu/cmd/tag_cmd.py`.
"""

from __future__ import annotations

import argparse
import logging

from ..dataio import DataSourceParam, JSONCDMIPsReader, JSONCDMIPsWriter
from .args import add_common_args

LOG = logging.getLogger(__name__)

_PAGE = 1000


def add_parser(subparsers) -> None:
    p = subparsers.add_parser("tag", help="bulk tag neuron metadata")
    add_common_args(p)
    p.add_argument("--mips-file", default=None)
    p.add_argument("--db", default=None,
                   help="tag neurons in this store instead of a JSON file")
    p.add_argument("--tag", nargs="+", required=True)
    p.add_argument("--remove", action="store_true")
    p.add_argument("-as", "--alignment-space", default=None)
    p.add_argument("--library", nargs="*", default=[])
    p.add_argument("--names", nargs="*", default=[])
    p.add_argument("--mip-ids", nargs="*", default=[])
    p.add_argument("--source-refs", nargs="*", default=[],
                   help="source sample/body ref IDs")
    p.add_argument("--datasets", nargs="*", default=[])
    p.add_argument("--tags", nargs="*", default=[],
                   help="only entities already carrying these tags")
    p.add_argument("--excluded-tags", nargs="*", default=[])
    p.add_argument("--annotations", nargs="*", default=[],
                   help="only entities with these neuron terms")
    p.add_argument("--excluded-annotations", nargs="*", default=[])
    p.set_defaults(func=run)


def _selector(args) -> DataSourceParam:
    return DataSourceParam(
        alignment_space=args.alignment_space,
        libraries=list(args.library or []),
        names=list(args.names or []),
        mip_ids=list(args.mip_ids or []),
        source_ref_ids=set(args.source_refs or []),
        datasets=set(args.datasets or []),
        tags=set(args.tags or []),
        excluded_tags=set(args.excluded_tags or []),
        annotations=set(args.annotations or []),
        excluded_annotations=set(args.excluded_annotations or []))


def run(args: argparse.Namespace) -> int:
    if not args.mips_file and not args.db:
        LOG.error("--mips-file or --db required")
        return 1
    base = _selector(args)
    n = 0

    def apply(e) -> bool:
        changed = False
        for tag in args.tag:
            if args.remove:
                if tag in e.tags:
                    e.tags.discard(tag)
                    changed = True
            elif tag not in e.tags:
                e.tags.add(tag)
                changed = True
        return changed

    if args.db:
        from .backends import get_store
        from ..dataio.base import AppendField, RemoveField
        store = get_store(args.db)

        def push_tags(changed):
            # server-side tag updates via field handlers ($addToSet /
            # $pullAll on Mongo) instead of whole-doc replace — the
            # reference's TagNeuronMetadataCmd path
            # (MongoDaoHelper.java:259-287)
            upd = ({"tags": RemoveField(sorted(set(args.tag)))}
                   if args.remove
                   else {"tags": AppendField(sorted(set(args.tag)))})
            for e in changed:
                store.update_entity_fields("neurons", e.entity_id,
                                           dict(upd))
        # if the applied tag feeds back into the selection (adding a tag
        # listed in --excluded-tags, or removing one listed in --tags),
        # paging over a mutating result set would skip entities at page
        # boundaries — snapshot the matching ids up front instead
        feedback = (set(args.tag) & base.excluded_tags if not args.remove
                    else set(args.tag) & base.tags)
        if feedback:
            ids = [e.entity_id for e in store.find_neurons(base)
                   if e.entity_id is not None]
            for i in range(0, len(ids), _PAGE):
                batch = store.find_neurons(
                    DataSourceParam(entity_ids=set(ids[i:i + _PAGE])))
                changed = [e for e in batch if apply(e)]
                if changed:
                    push_tags(changed)
                n += len(changed)
            LOG.info("%s %d entities",
                     "untagged" if args.remove else "tagged", n)
            return 0
        offset = 0
        while True:
            sel = DataSourceParam(offset=offset, size=_PAGE,
                                  **{k: getattr(base, k) for k in (
                                      "alignment_space", "libraries",
                                      "names", "mip_ids", "source_ref_ids",
                                      "datasets", "tags", "excluded_tags",
                                      "annotations",
                                      "excluded_annotations")})
            batch = store.find_neurons(sel)
            if not batch:
                break
            changed = [e for e in batch if apply(e)]
            if changed:
                push_tags(changed)
            n += len(changed)
            if len(batch) < _PAGE:
                break
            offset += _PAGE
    else:
        # the grouped JSON file must be rewritten whole either way
        all_entities = JSONCDMIPsReader(args.mips_file).read_mips(
            DataSourceParam())
        for e in all_entities:
            if base.matches_entity(e) and apply(e):
                n += 1
        w = JSONCDMIPsWriter(args.mips_file)
        w.open()
        w.write(all_entities)
        w.close()
    LOG.info("%s %d entities", "untagged" if args.remove else "tagged", n)
    return 0
