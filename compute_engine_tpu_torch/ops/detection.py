"""SSD detection post-processing: box decode + NMS, int8 inputs supported.

The port of ``compute_engine_tpu.ops.detection``, the counterpart of LCE's
DetectionPostProcess pass (`mlir/transforms/detection_postprocess.cc:24-186`),
whose job is to make the TFLite ``TFLite_Detection_PostProcess`` custom op
consume the int8 tensors a quantized SSD head produces directly. Here the op
itself is provided, in plain torch on the caller's device: the TFLite custom
op's semantics (decode with y/x/h/w scales, fast max-class NMS or regular
per-class NMS), with the dequantisation of int8 inputs inside (pass int8
tensors plus ``(scale, zero_point)``).

Outputs have fixed shapes (always ``max_detections`` long, with a
``num_detections`` count). The NMS is a loop of ``max_detections`` steps over
the whole batch (and, for regular NMS, over all classes at once): each step is
an argmax and a vectorised IoU suppression, and no step reads a value back to
the host, so on a card the loop is enqueued without a synchronisation.
"""

from __future__ import annotations

import torch

__all__ = ["detection_postprocess"]

_NEG_INF = -1e9


def _dequant(x, quant, name):
    """Inline dequantize: int8 tensor + (scale, zero_point) -> float32."""
    if quant is None:
        if x.dtype == torch.int8:
            raise TypeError(f"{name} is int8 but no (scale, zero_point) "
                            f"was given")
        return x.to(torch.float32)
    if x.dtype != torch.int8:
        raise TypeError(f"{name} has quantization params but dtype "
                        f"{x.dtype} != int8")
    scale, zero_point = quant
    return (x.to(torch.float32) - float(zero_point)) * float(scale)


def _decode_boxes(raw, anchors, scales):
    """TFLite CenterSize decode -> (ymin, xmin, ymax, xmax)."""
    y_scale, x_scale, h_scale, w_scale = scales
    ya, xa, ha, wa = anchors.unbind(-1)
    ty, tx, th, tw = raw.unbind(-1)
    ycenter = ty / y_scale * ha + ya
    xcenter = tx / x_scale * wa + xa
    half_h = 0.5 * torch.exp(th / h_scale) * ha
    half_w = 0.5 * torch.exp(tw / w_scale) * wa
    return torch.stack([ycenter - half_h, xcenter - half_w,
                        ycenter + half_h, xcenter + half_w], dim=-1)


def _iou_one_vs_all(box, boxes):
    """IoU of one box per row, (R, 4), against that row's (R, A, 4) boxes;
    zero-area safe."""
    box = box[:, None, :]
    ymin = torch.maximum(box[..., 0], boxes[..., 0])
    xmin = torch.maximum(box[..., 1], boxes[..., 1])
    ymax = torch.minimum(box[..., 2], boxes[..., 2])
    xmax = torch.minimum(box[..., 3], boxes[..., 3])
    inter = (ymax - ymin).clamp(min=0.0) * (xmax - xmin).clamp(min=0.0)
    area = ((box[..., 2] - box[..., 0]).clamp(min=0.0)
            * (box[..., 3] - box[..., 1]).clamp(min=0.0))
    areas = ((boxes[..., 2] - boxes[..., 0]).clamp(min=0.0)
             * (boxes[..., 3] - boxes[..., 1]).clamp(min=0.0))
    union = area + areas - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(union))


def _nms(boxes, scores, max_out, iou_threshold, score_threshold):
    """Greedy fixed-shape NMS over R independent rows.

    ``boxes`` (R, A, 4), ``scores`` (R, A). Returns (indices (R, max_out),
    valid (R, max_out) bool); invalid slots carry index 0 and valid=False.
    One step = one selection per row: argmax over the live scores, then a
    vectorised IoU suppression.
    """
    rows, n_anchors = scores.shape
    neg = torch.full_like(scores, _NEG_INF)
    live = torch.where(scores > score_threshold, scores, neg)
    idxs = torch.zeros((rows, max_out), dtype=torch.int64,
                       device=scores.device)
    valid = torch.zeros((rows, max_out), dtype=torch.bool,
                        device=scores.device)
    anchor_ids = torch.arange(n_anchors, device=scores.device)[None]
    row_ids = torch.arange(rows, device=scores.device)
    for i in range(max_out):
        best = live.argmax(dim=1)
        ok = live[row_ids, best] > _NEG_INF / 2
        idxs[:, i] = torch.where(ok, best, torch.zeros_like(best))
        valid[:, i] = ok
        iou = _iou_one_vs_all(boxes[row_ids, best], boxes)
        suppress = (iou >= iou_threshold) | (anchor_ids == best[:, None])
        live = torch.where(ok[:, None] & suppress, neg, live)
    return idxs, valid


def _gather_rows(x, idx):
    """``x[b, idx[b, j]]`` for x (B, A, ...) and idx (B, J)."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def _postprocess(raw_boxes, class_scores, anchors, *, scales,
                 max_detections, iou_threshold, score_threshold,
                 use_regular_nms, max_classes_per_detection):
    boxes = _decode_boxes(raw_boxes, anchors, scales)  # (B, A, 4)
    batch, n_anchors, num_classes = class_scores.shape

    if use_regular_nms:
        # Per-class NMS, then the global top max_detections across classes
        # (`detection_postprocess.cc` regular path semantics). Every (image,
        # class) pair is one row of one NMS loop.
        per_class = class_scores.permute(0, 2, 1)  # (B, C, A)
        idxs, valid = _nms(
            boxes[:, None].expand(batch, num_classes, n_anchors, 4).reshape(
                batch * num_classes, n_anchors, 4),
            per_class.reshape(batch * num_classes, n_anchors),
            max_detections, iou_threshold, score_threshold)
        kept = per_class.reshape(batch * num_classes, n_anchors).gather(
            1, idxs)
        cand_scores = torch.where(valid, kept, torch.full_like(
            kept, _NEG_INF)).reshape(batch, num_classes * max_detections)
        cand_classes = torch.arange(
            num_classes, device=boxes.device).repeat_interleave(
                max_detections)
        cand_idx = idxs.reshape(batch, num_classes * max_detections)
        out_scores, top = torch.topk(cand_scores, max_detections, dim=1)
        valid = out_scores > _NEG_INF / 2
        out_boxes = _gather_rows(boxes, cand_idx.gather(1, top))
        out_classes = cand_classes[top]
    else:
        # Fast path: one NMS on the per-anchor max class score; each kept
        # anchor emits its top max_classes_per_detection classes.
        anchor_best = class_scores.max(dim=-1).values  # (B, A)
        idxs, valid = _nms(boxes, anchor_best, max_detections,
                           iou_threshold, score_threshold)
        k = min(max_classes_per_detection, num_classes)
        kept_scores, kept_classes = torch.topk(
            _gather_rows(class_scores, idxs), k, dim=-1)
        out_boxes = _gather_rows(boxes, idxs).repeat_interleave(
            k, dim=1)[:, :max_detections]
        out_classes = kept_classes.reshape(batch, -1)[:, :max_detections]
        out_scores = kept_scores.reshape(batch, -1)[:, :max_detections]
        valid = valid.repeat_interleave(k, dim=1)[:, :max_detections]

    out_boxes = torch.where(valid[..., None], out_boxes,
                            torch.zeros_like(out_boxes))
    out_classes = torch.where(valid, out_classes,
                              torch.zeros_like(out_classes)).to(torch.int32)
    out_scores = torch.where(valid, out_scores, torch.zeros_like(out_scores))
    return out_boxes, out_classes, out_scores, valid.sum(-1, dtype=torch.int32)


def detection_postprocess(boxes, scores, anchors, *,
                          max_detections=10,
                          iou_threshold=0.6,
                          score_threshold=0.001,
                          scales=(10.0, 10.0, 5.0, 5.0),
                          use_regular_nms=False,
                          max_classes_per_detection=1,
                          boxes_quant=None,
                          scores_quant=None,
                          anchors_quant=None):
    """TFLite ``Detection_PostProcess`` semantics, on the inputs' device.

    Args:
      boxes:   (B, A, 4) encoded [ty, tx, th, tw] — float or int8 tensor.
      scores:  (B, A, C) class scores (post-sigmoid) — float or int8.
      anchors: (A, 4) [ycenter, xcenter, h, w] — float or int8.
      scales:  (y, x, h, w) decode scales.
      *_quant: optional (scale, zero_point) per int8 input; when given the
        dequantisation happens inside this op (LCE's int8 rewire,
        `detection_postprocess.cc:24-186`).

    Returns:
      nmsed_boxes (B, max_detections, 4) [ymin, xmin, ymax, xmax],
      classes (B, max_detections) int32, scores (B, max_detections),
      num_detections (B,) int32 — the custom op's 4 outputs. Slots past
      ``num_detections`` are zero.
    """
    if boxes.ndim != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be (B, A, 4), got {tuple(boxes.shape)}")
    if scores.ndim != 3 or scores.shape[:2] != boxes.shape[:2]:
        raise ValueError(f"scores must be (B, A, C), got "
                         f"{tuple(scores.shape)} for boxes "
                         f"{tuple(boxes.shape)}")
    if tuple(anchors.shape) != (boxes.shape[1], 4):
        raise ValueError(f"anchors must be (A, 4) = ({boxes.shape[1]}, 4), "
                         f"got {tuple(anchors.shape)}")
    return _postprocess(
        _dequant(boxes, boxes_quant, "boxes"),
        _dequant(scores, scores_quant, "scores"),
        _dequant(anchors, anchors_quant, "anchors"),
        scales=tuple(scales), max_detections=int(max_detections),
        iou_threshold=float(iou_threshold),
        score_threshold=float(score_threshold),
        use_regular_nms=bool(use_regular_nms),
        max_classes_per_detection=int(max_classes_per_detection))
