"""ONNX graph surgery on the port's messages (tools/model_converter/
onnx_edit.py, reference tools/model_converter/onnx_edit.py:13-53):

* `remove_trailing_transpose`: a Transpose that produces a graph output is
  bypassed (an Identity takes its place) and the declared shape un-permuted;
* `add_nchw_output`: each 4-D NHWC output gets a Transpose(0, 3, 1, 2), for
  the deployment stacks that want NCHW (RKNN and others);
* `rename_io`: the first graph input and output renamed in place.

    python -m deeplabv3p_torch.tools.onnx_edit --input_model m.onnx \\
        --output_model m_nchw.onnx --nchw_output
"""

from __future__ import annotations

import argparse

from deeplabv3p_torch.export.onnx import proto
from deeplabv3p_torch.export.onnx.convert import load_onnx, make_attribute, save_onnx


def _perm_of(node: proto.NodeProto) -> list[int]:
    return next((list(a.ints) for a in node.attribute if a.name == "perm"), [])


def _set_dims(vi: proto.ValueInfoProto, dims) -> None:
    vi.type.tensor_type.shape.dim = [proto.TensorShapeProto.Dimension(dim_value=int(d))
                                     for d in dims]


def _dims(vi: proto.ValueInfoProto) -> list[int]:
    return [d.dim_value for d in vi.type.tensor_type.shape.dim]


def remove_trailing_transpose(model: proto.ModelProto) -> bool:
    """Bypass each Transpose that directly produces a graph output; returns
    whether one was."""
    graph = model.graph
    changed = False
    producers = {n.output[0]: n for n in graph.node}
    for out in graph.output:
        node = producers.get(out.name)
        if node is None or node.op_type != "Transpose":
            continue
        perm = _perm_of(node)
        graph.node.remove(node)
        graph.node.append(proto.NodeProto(input=[node.input[0]], output=[out.name],
                                          name=f"{out.name}_identity", op_type="Identity"))
        dims = _dims(out)
        if perm and len(dims) == len(perm):
            inv = [0] * len(perm)
            for i, j in enumerate(perm):
                inv[j] = i
            _set_dims(out, [dims[i] for i in inv])
        changed = True
    return changed


def add_nchw_output(model: proto.ModelProto) -> None:
    """Flip each 4-D NHWC graph output to NCHW."""
    graph = model.graph
    for out in graph.output:
        dims = _dims(out)
        if len(dims) != 4:
            continue
        internal = out.name + "_nhwc"
        for node in graph.node:
            node.output = [internal if o == out.name else o for o in node.output]
        graph.node.append(proto.NodeProto(input=[internal], output=[out.name],
                                          name=out.name + "_to_nchw", op_type="Transpose",
                                          attribute=[make_attribute("perm", [0, 3, 1, 2])]))
        n, h, w, c = dims
        _set_dims(out, (n, c, h, w))


def rename_io(model: proto.ModelProto, input_name: str | None = None,
              output_name: str | None = None) -> None:
    graph = model.graph
    if input_name and graph.input:
        old, graph.input[0].name = graph.input[0].name, input_name
        for node in graph.node:
            node.input = [input_name if x == old else x for x in node.input]
    if output_name and graph.output:
        old, graph.output[0].name = graph.output[0].name, output_name
        for node in graph.node:
            node.output = [output_name if o == old else o for o in node.output]


def main(args) -> None:
    model = load_onnx(args.input_model)
    if args.remove_trailing_transpose:
        remove_trailing_transpose(model)
    if args.nchw_output:
        add_nchw_output(model)
    if args.input_name or args.output_name:
        rename_io(model, args.input_name, args.output_name)
    save_onnx(model, args.output_model)
    print(f"wrote {args.output_model}")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--input_model", required=True)
    p.add_argument("--output_model", required=True)
    p.add_argument("--remove_trailing_transpose", action="store_true")
    p.add_argument("--nchw_output", action="store_true")
    p.add_argument("--input_name", default=None)
    p.add_argument("--output_name", default=None)
    return p.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
