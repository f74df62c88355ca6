"""The frozen TensorFlow graph, with no `tensorflow` and no `protobuf`
import: the GraphDef messages on the port's own wire codec (`graph_pb.py`),
the lowering of the port's ONNX graph to plain TF ops (`lower.py`), an
executor of such graphs in torch ops on a device (`interp.py`) and the
SavedModel messages that wrap such a graph (`saved_model.py`).
`export/tf_export.py` holds the public names.
"""
