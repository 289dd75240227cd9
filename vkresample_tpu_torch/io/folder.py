"""Batched-folder file protocol (counterpart of vkresample_tpu/io/folder.py).

The reference's batched mode names frames ``prefix/%06d.png`` with 1-based
indices (VkResample.cpp:1357, 1629: "They should have names like prefix +
000001.png with numbers padded with zeros to six digits").  ``-ifolder``
takes a folder-plus-prefix string like ``inp/img``.
"""
from __future__ import annotations

from typing import List


def frame_path(prefix: str, index: int) -> str:
    """1-based frame path: prefix + '/%06d.png' (VkResample.cpp:1357).

    The reference inserts '/' between the prefix and the number, so a
    prefix like 'inp/img' yields 'inp/img/000001.png'.
    """
    return "%s/%06d.png" % (prefix, index)


def frame_paths(prefix: str, num_files: int) -> List[str]:
    return [frame_path(prefix, i + 1) for i in range(num_files)]
