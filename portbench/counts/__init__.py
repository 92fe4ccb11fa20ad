"""The yardstick's counts: the H100's published peaks (``peaks.json``,
with its source) here, and a model family's kernel bytes and operations in
a file of its own (``dlrm.py``).
"""
import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())
