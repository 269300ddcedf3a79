"""Static block assignment of the mask x target grid to processes.

Copy of `colormipsearch_tpu/parallel/distributed.py` (:41-73): the
reference's LSF job arrays index static (maskBlock, targetBlock) offsets
(scripts/submitCDSBatch.sh:10-36, submitCDSJob.sh:58-66); a process
derives its block of the pair grid from its process id, so a failed
process is resumed by running the same id again.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class PairBlock:
    """A static block of the mask x target grid owned by one process
    (the LSF JOB_INDEX -> (maskBlock, targetBlock) mapping,
    submitCDSJob.sh:58-66)."""
    mask_offset: int
    mask_length: int
    target_offset: int
    target_length: int


def block_for_process(n_masks: int, n_targets: int,
                      process_id: int, process_count: int,
                      jobs_for_masks: Optional[int] = None) -> PairBlock:
    """Deterministic block assignment; restartable per-process with the
    same offsets (resume = re-run the failed process id)."""
    if jobs_for_masks is None:
        # squarest split of processes over the grid
        jobs_for_masks = 1
        for m in range(1, int(process_count ** 0.5) + 1):
            if process_count % m == 0:
                jobs_for_masks = m
    jobs_for_targets = process_count // jobs_for_masks
    mi = process_id % jobs_for_masks
    ti = process_id // jobs_for_masks
    mask_len = -(-n_masks // jobs_for_masks)
    target_len = -(-n_targets // jobs_for_targets)
    return PairBlock(
        mask_offset=mi * mask_len,
        mask_length=min(mask_len, max(0, n_masks - mi * mask_len)),
        target_offset=ti * target_len,
        target_length=min(target_len, max(0, n_targets - ti * target_len)),
    )
