"""Runtime utilities. The tracing facade (``trace``) is ported; the slot
clock and snappy framing of the reference's ``utils/`` wait for the data
planes."""
