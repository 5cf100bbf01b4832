"""Stage 2, auto-seg: temporally consistent instance masks for a video
(SAM proposals aligned by SAM2 video propagation)."""
