"""copyToMipsStore command: copy/normalize MIP files into a canonical
store layout WITH the canonical naming-convention renames
(cmd/CopyToMIPsStore.java:65-344): EM variants keep their name; LM
variants are renamed to

  <prefix><slideCode>-<objective>-<area>-<alignmentSpace>-<sampleRef>-
  CH<channel>[-<segmentIndex>]_CDM<ext>

so any store copied this way re-imports by naming convention.

Copy of `colormipsearch_tpu/cmd/copymips_cmd.py`.
"""

from __future__ import annotations

import argparse
import logging
import os
import re

from ..dataio import DataSourceParam, JSONCDMIPsReader, JSONCDMIPsWriter
from ..model import ComputeFileType, FileData
from .args import add_common_args
from .mipstores import is_em_library

LOG = logging.getLogger(__name__)

# variant name -> compute file type (CopyToMIPsStore.java:52-61)
VARIANT_FILE_TYPE_MAPPING = {
    "cdm": ComputeFileType.SourceColorDepthImage,
    "searchable_neurons": ComputeFileType.InputColorDepthImage,
    "segmentation": ComputeFileType.InputColorDepthImage,
    "grad": ComputeFileType.GradientImage,
    "gradient": ComputeFileType.GradientImage,
    "zgap": ComputeFileType.ZGapImage,
    "rgb": ComputeFileType.ZGapImage,
    "junk": ComputeFileType.JunkImage,
}

# canonical store sub-layout per variant when no explicit mapping given
_DEFAULT_MAPPING = {
    "cdm": "",
    "searchable_neurons": "searchable_neurons",
    "grad": "grad",
    "zgap": "zgap",
}

_EXT_RE = re.compile(r".+(\..*)$")
_SEGMENT_INDEX_RE = re.compile(r".+[_-]ch?\d+_+(\d+)\..*$", re.IGNORECASE)


def add_parser(subparsers) -> None:
    p = subparsers.add_parser("copyToMipsStore",
                              help="copy MIPs into a canonical store layout")
    add_common_args(p)
    p.add_argument("--mips-file", "--input", "-i", dest="mips_file",
                   required=True)
    p.add_argument("--target-folder", "--targetDirectory",
                   dest="target_folder", default=None,
                   help="destination store root (falls back to -od, "
                        "CopyToMIPsStore.java getOutputDir:98-106)")
    p.add_argument("--mipsFilter", nargs="*", default=[],
                   help="restrict to these published names / mip IDs")
    p.add_argument("--surjective-variants-mapping", nargs="*", default=[],
                   metavar="VARIANT=FOLDER",
                   help="variant type -> destination folder pairs "
                        "(default: cdm/searchable_neurons/grad/zgap "
                        "canonical layout)")
    p.add_argument("-n", "--simulate", action="store_true",
                   help="only log what would be copied")
    p.add_argument("-f", "--force", action="store_true",
                   help="overwrite existing destination files")
    p.add_argument("--lmIgnoreMissingSegmentation", action="store_true",
                   help="do not error for LM variants without a segment "
                        "index in their name")
    p.add_argument("--update-mips", action="store_true",
                   help="rewrite the MIP JSON pointing at the new store")
    p.set_defaults(func=run)


def _segment_index(args, cft: ComputeFileType, name: str) -> str:
    m = _SEGMENT_INDEX_RE.match(name)
    seg = m.group(1) if m else ""
    if not seg:
        if args.lmIgnoreMissingSegmentation or \
                cft == ComputeFileType.SourceColorDepthImage:
            return ""
        raise ValueError(
            f"Segment index not found or empty in {name!r}")
    return seg


def _name_ext(name: str) -> str:
    m = _EXT_RE.match(name)
    return m.group(1) if m else ""


def create_lm_mip_name(e, cdm_name: str, cft: ComputeFileType,
                       variant_name: str, args) -> str:
    """createLMMIPName (CopyToMIPsStore.java:199-268): rebuild the
    canonical segment name from entity metadata, extracting the prefix
    and channel from the source CDM name by position (hyphens inside the
    line prefix make pure splitting unreliable)."""
    base = re.sub(r"(_CDM)?\..*$", "", cdm_name)
    slide_code = e.slide_code or ""
    sample_ref = re.sub(r"(?i)^Sample#", "", e.source_ref_id or "")
    sc_idx = base.find(slide_code) if slide_code else -1
    if sc_idx == -1:
        LOG.error("CDM name %s does not contain the slide code (%s) and "
                  "does not match the naming convention", cdm_name,
                  slide_code)
        prefix = ""
    else:
        prefix = cdm_name[:sc_idx]
    internal = e.internal_line_name
    if internal:
        if prefix and not prefix.startswith(internal):
            LOG.info("internal line name %r and prefix %r do not match "
                     "in %s", internal, prefix, cdm_name)
            prefix = internal + "-"
        elif not prefix:
            prefix = internal + "-"
    sr_idx = base.find(sample_ref) if sample_ref else -1
    if sr_idx == -1:
        LOG.error("CDM name %s does not contain the sample ID (%s)",
                  cdm_name, sample_ref)
        channel_comp = base.split("-")[-1]
    else:
        start = sr_idx + len(sample_ref) + 1
        channel_comp = (base[start:] if start < len(base)
                        else base.split("-")[-1])
    channel = re.sub(r"(?i)^c", "", channel_comp)
    channel = re.sub(r"(?i)^h", "", channel)
    segment_name = (f"{prefix}{slide_code}-{e.objective}-"
                    f"{e.anatomical_area}-{e.alignment_space}-"
                    f"{sample_ref}-CH{channel}")
    seg_idx = _segment_index(args, cft, variant_name)
    ext = _name_ext(variant_name)
    if seg_idx:
        return f"{segment_name}-{seg_idx}_CDM{ext}"
    return f"{segment_name}_CDM{ext}"


def create_mip_variant_name(e, cdm_name: str, cft: ComputeFileType,
                            variant_name: str, args) -> str:
    if is_em_library(e.library_name):
        return variant_name  # createEMMIPName: as-is
    return create_lm_mip_name(e, cdm_name, cft, variant_name, args)


def _read_file_data(fd: FileData):
    if fd.entry_name:
        import zipfile
        with zipfile.ZipFile(fd.file_name) as zf:
            return zf.read(fd.entry_name)
    if not os.path.exists(fd.file_name):
        return None
    with open(fd.file_name, "rb") as f:
        return f.read()


def run(args: argparse.Namespace) -> int:
    if not args.target_folder:
        args.target_folder = args.output_dir
    if not args.target_folder:
        LOG.error("--target-folder or -od required")
        return 1
    # -i accepts the reference's '<path>:<offset>:<length>' ListArg form
    # (CopyToMIPsStore.java:68-70, readMIPs :174-183)
    from .args import ListArg
    la = ListArg.parse(args.mips_file)
    reader = JSONCDMIPsReader(la.input)
    entities = reader.read_mips(DataSourceParam(offset=la.offset,
                                                size=la.length))
    # filter: lowercase publishedName match OR exact mipId match
    # (CopyToMIPsStore.java:178-180)
    flt_raw = set(args.mipsFilter or [])
    flt = {s.lower() for s in flt_raw}
    if flt:
        entities = [e for e in entities
                    if (e.published_name or "").lower() in flt
                    or (e.mip_id or "") in flt_raw]
    mapping = dict(_DEFAULT_MAPPING)
    if args.surjective_variants_mapping:
        mapping = {}
        for spec in args.surjective_variants_mapping:
            vt, _, folder = spec.partition("=")
            mapping[vt] = folder
    n = 0
    seen = set()
    for e in entities:
        src = e.compute_files.get(ComputeFileType.SourceColorDepthImage)
        if src is None:
            continue
        cdm_name = src.name_component
        for vt, folder in mapping.items():
            cft = VARIANT_FILE_TYPE_MAPPING.get(vt)
            if cft is None or cft not in e.compute_files:
                continue
            fd = e.compute_files[cft]
            try:
                target_name = create_mip_variant_name(
                    e, cdm_name, cft, fd.name_component, args)
            except ValueError as err:
                LOG.error("skipping %s: %s", fd.name_component, err)
                continue
            dest_dir = os.path.join(args.target_folder, folder)
            dest = os.path.join(dest_dir, target_name)
            if (fd.file_name, fd.entry_name, dest) in seen:
                continue  # .distinct() — variants may repeat across MIPs
            seen.add((fd.file_name, fd.entry_name, dest))
            if args.simulate:
                # simulateCopyFileData (CopyToMIPsStore.java:329-343):
                # missing source is an ERROR (counted only with -f),
                # existing destination a WARNING (never counted)
                from ..mips.loader import filedata_exists
                if not filedata_exists(fd):
                    LOG.error("cp %s %s => ERROR: source not found",
                              fd.name_component, dest)
                    if args.force:
                        n += 1
                    continue
                if os.path.exists(dest):
                    LOG.warning("cp %s %s => WARNING: destination exists",
                                fd.name_component, dest)
                    continue
                LOG.info("cp %s %s", fd.name_component, dest)
                n += 1
                continue
            data = _read_file_data(fd)
            if data is None:
                LOG.warning("%s data not found", fd.file_name)
                continue
            if os.path.exists(dest) and not args.force:
                LOG.warning("destination exists: %s", dest)
                continue
            os.makedirs(dest_dir, exist_ok=True)
            with open(dest, "wb") as out:
                out.write(data)
            if args.update_mips:
                e.compute_files[cft] = FileData.from_string(dest)
            n += 1
    if args.update_mips and not args.simulate:
        w = JSONCDMIPsWriter(args.mips_file)
        w.open()
        w.write(entities)
        w.close()
    LOG.info("copied %d variants into %s", n, args.target_folder)
    return 0
