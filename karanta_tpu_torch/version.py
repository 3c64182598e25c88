"""Version stamp, recorded into Dolma document metadata.

Plays the role of the reference's `olmocr.version.VERSION` import
(reference: karanta/pipeline.py:41,564).
"""

VERSION = "0.1.0"
__version__ = VERSION
