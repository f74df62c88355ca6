"""Single-image inference API (deeplabv3p_tpu/inference.py:28-150).

`DeepLab` takes the JAX class's configuration keys and adds an explicit
`device` (default `cuda`) and compute `dtype` (default bf16, the JAX class's
compute type). Like the JAX class it builds with the fused ASPP kernel on
and the fused decoder kernel off (and the fused inverted-residual kernel
off); the flags can be overridden. Any of the 22 models of
`models.factory.build_segmentation_model` serves; a UNet or Fast-SCNN has
no ASPP or decoder, so the two flags go unused there. A request
is `preprocess_image` (PIL bicubic resize + [-1, 1] normalise, on the host)
-> model forward -> argmax -> (with `do_crf`, the dense CRF of
`postprocess.crf_postprocess` on the denormalised input) -> cv2-nearest
`mask_resize`, all but the first on the device.

`mesh` (a `parallel.make_mesh` mesh with a 'spatial' axis, as in JAX
inference.py:98-121) splits each image's height over the spatial group:
every rank of the group runs the model on its block of rows
(`parallel/spatial.py`), and the mask's rows are gathered so that every
rank returns the whole mask; the 'data' axis replicates. A mesh without a
'spatial' axis raises as in JAX.

Weights come from an `.npz` of the JAX variables tree (`utils/weights.py`),
the JAX package's `.ckpt` or a Keras `.h5` (`utils/checkpoint.load_weights`),
or, with no path, from a seeded init. PIL is imported only where an image
is decoded or drawn, so `import deeplabv3p_torch.inference` works without it.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from deeplabv3p_torch.models.factory import build_segmentation_model
from deeplabv3p_torch.models.layers import init_parameters
from deeplabv3p_torch.parallel.mesh import Mesh
from deeplabv3p_torch.parallel.spatial import gather_rows, height_of, own_rows, partitioned
from deeplabv3p_torch.postprocess import crf_postprocess, mask_argmax, mask_resize
from deeplabv3p_torch.utils.config import get_classes
from deeplabv3p_torch.utils.checkpoint import load_weights

DEFAULT_CONFIG = {
    # reference default_config (deeplab.py:31-40)
    "model_type": "mobilenetv2_lite",
    "classes_path": None,
    "class_names": None,
    "model_input_shape": (512, 512),
    "output_stride": 16,
    "weights_path": None,
    "do_crf": False,
    "mesh": None,
}


def preprocess_image(image, model_input_shape) -> np.ndarray:
    """PIL bicubic resize + [-1, 1] normalize + batch dim (reference
    common/data_utils.py:436-454)."""
    from PIL import Image

    resized = image.resize(tuple(reversed(model_input_shape)), Image.BICUBIC)
    data = np.asarray(resized).astype("float32") / 127.5 - 1.0
    return np.expand_dims(data, 0)


def denormalize_image(image: torch.Tensor) -> torch.Tensor:
    """[-1, 1] image -> uint8, bit for bit the JAX package's numpy
    `(image * 127.5 + 127.5).astype(np.uint8)`: an f32 product, then an f32
    sum (two ops, so no fused multiply-add rounds once where numpy rounds
    twice), truncated toward zero by the cast."""
    return (image.to(torch.float32) * 127.5 + 127.5).to(torch.uint8)


class DeepLab:
    """Inference wrapper with overridable defaults (`DeepLab(**overrides)`,
    reference deeplab.py:53-58)."""

    def __init__(
        self,
        device="cuda",
        dtype: torch.dtype = torch.bfloat16,
        fused_aspp: bool = True,
        fused_decoder: bool = False,
        fused_mbconv: bool = False,
        **kwargs,
    ):
        self.__dict__.update(DEFAULT_CONFIG)
        self.__dict__.update(kwargs)
        if self.mesh is not None and not isinstance(self.mesh, Mesh):
            raise TypeError(f"mesh must be a deeplabv3p_torch.parallel.Mesh (make_mesh), not "
                            f"{type(self.mesh).__name__}")
        if self.mesh is not None and self.mesh.size > 1:
            # JAX inference.py:98-112: batch-1 inference splits the image's
            # height over the 'spatial' axis; the 'data' axis replicates
            if "spatial" not in self.mesh.axis_names:
                raise ValueError(
                    "multi-chip inference needs a mesh with a 'spatial' axis "
                    "(make_mesh(n, axis_names=('data', 'spatial'))): a single image "
                    "cannot shard over a pure 'data' mesh")
            device = self.mesh.device
        if self.class_names is None:
            if self.classes_path is None:
                raise ValueError("need class_names or classes_path")
            self.class_names = get_classes(self.classes_path)
        if len(self.class_names) >= 254:
            raise ValueError("PNG image label only support less than 254 classes.")
        self.num_classes = len(self.class_names)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            # nothing moves to the CPU behind the caller's back
            raise RuntimeError(
                "device='cuda' but torch.cuda.is_available() is False; "
                "pass device='cpu' to run the plain PyTorch path"
            )
        self.dtype = dtype
        self.model = build_segmentation_model(
            self.model_type,
            self.num_classes,
            output_stride=self.output_stride,
            fused_aspp=fused_aspp,
            fused_decoder=fused_decoder,
            fused_mbconv=fused_mbconv,
            dtype=dtype,
            device=self.device,
        )
        # seeded random init (smoke/demo use; what an .h5 lacks keeps it)
        init_parameters(self.model, torch.Generator().manual_seed(0))
        if self.weights_path:
            load_weights(os.path.expanduser(self.weights_path), self.model)
        self._split = self.mesh is not None and self.mesh.spatial > 1

    @torch.inference_mode()
    def predict(self, image_data: np.ndarray, image_shape) -> np.ndarray:
        """image_data: (1, H, W, 3) normalized; image_shape: origin (h, w).
        Returns the (h, w) int32 mask (reference deeplab.py:96-109); with
        `do_crf` the mask is refined by the dense CRF on this device before
        the resize (JAX inference.py:133-136)."""
        x = torch.from_numpy(np.ascontiguousarray(image_data, np.float32)).to(self.device)
        if self._split:
            mask = self._predict_rows(x)
        else:
            logits = self.model(x.permute(0, 3, 1, 2))  # NHWC -> channels_last NCHW
            mask = mask_argmax(logits, dim=1)[0]
        if self.do_crf:
            mask = crf_postprocess(denormalize_image(x[0]), mask)
        return mask_resize(mask, tuple(image_shape)).cpu().numpy()

    def _predict_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The mask of one image on a spatial mesh, as one process's: this
        rank's block of rows through the model and the argmax, then the
        mask's rows gathered over the spatial group, so every rank holds the
        whole mask. It is as high as the logits, which is the image's height
        or, for `unet_simple` off multiples of 16, its own (80 rows for
        68)."""
        with partitioned(self.mesh, x.shape[1:3]) as part:
            logits = self.model(own_rows(x, self.mesh).permute(0, 3, 1, 2))
            h = height_of(logits)
        return gather_rows(mask_argmax(logits, dim=1)[0], h, part, dim=0)

    def segment_image(self, image):
        """Segment a PIL image, return the overlay visualization
        (reference deeplab.py:81-93)."""
        from PIL import Image

        from deeplabv3p_torch.utils.visualize import visualize_segmentation

        image_data = preprocess_image(image, self.model_input_shape)
        image_shape = tuple(reversed(image.size))  # (h, w)
        start = time.time()
        out_mask = self.predict(image_data, image_shape)
        print(f"Inference time: {time.time() - start:.8f}s")
        image_array = visualize_segmentation(
            np.array(image), out_mask, class_names=self.class_names
        )
        return Image.fromarray(image_array)

    def segment_video(self, video_path: str, output_path: Optional[str] = None) -> None:
        """Per-frame video segmentation with an FPS overlay (JAX
        inference.py:152-199, reference deeplab.py:123-172). `video_path`
        "0" opens the webcam; with `output_path` the overlays are written
        with the input's codec, rate and size."""
        import cv2
        from PIL import Image

        vid = cv2.VideoCapture(0 if video_path == "0" else video_path)
        if not vid.isOpened():
            raise IOError("Couldn't open webcam or video")
        out = None
        try:
            size = (int(vid.get(cv2.CAP_PROP_FRAME_WIDTH)),
                    int(vid.get(cv2.CAP_PROP_FRAME_HEIGHT)))
            if output_path:
                fourcc = int(vid.get(cv2.CAP_PROP_FOURCC))
                out = cv2.VideoWriter(output_path, fourcc, vid.get(cv2.CAP_PROP_FPS), size)
            accum_time, curr_fps, fps_txt = 0.0, 0, "FPS: ??"
            prev = time.time()
            while True:
                ok, frame = vid.read()
                if not ok:
                    break
                image = Image.fromarray(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
                result = np.asarray(self.segment_image(image))
                now = time.time()
                accum_time += now - prev
                prev = now
                curr_fps += 1
                if accum_time > 1:
                    accum_time -= 1
                    fps_txt, curr_fps = f"FPS: {curr_fps}", 0
                result = cv2.cvtColor(result, cv2.COLOR_RGB2BGR)
                if (result.shape[1], result.shape[0]) != size:
                    # the overlay renders at figure size; the writer only
                    # accepts frames at the capture size
                    result = cv2.resize(result, size)
                cv2.putText(result, fps_txt, (3, 15), cv2.FONT_HERSHEY_SIMPLEX,
                            0.50, (255, 0, 0), 2)
                if out is not None:
                    out.write(result)
        finally:
            vid.release()
            if out is not None:
                out.release()
