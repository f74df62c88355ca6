"""TFLite files, with no `tensorflow`, `tflite` or `flatbuffers` import: the
schema's tables on the port's own FlatBuffers codec (`schema.py`,
`export/flatbuf.py`), the lowering of the port's frozen GraphDef to TFLite
builtins (`lower.py`), its full-integer int8 form (`quantize.py`, on
TFLite's integer arithmetic in `fixed_point.py`) and an executor of such
files, float and int8, in torch ops on a device (`interp.py`).
`export/tf_export.py` holds the public names.
"""
