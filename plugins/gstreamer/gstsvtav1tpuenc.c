/*
 * GStreamer element "svtav1tpuenc" — the gstreamer-plugin analog of the
 * reference (ref gstreamer-plugin/gstsvtav1enc.c, 986 LoC): a
 * GstVideoEncoder subclass driving the public C API (native/capi.h).
 *
 * Build (meson snippet in this directory's README):
 *   cc -shared -fPIC gstsvtav1tpuenc.c -o libgstsvtav1tpuenc.so \
 *      $(pkg-config --cflags --libs gstreamer-video-1.0) \
 *      -I<repo>/native -L<repo>/native -lsvtav1_tpu
 * Runtime: PYTHONPATH=<repo> (the library embeds CPython) and
 *   GST_PLUGIN_PATH pointing here.
 * NOT compiled in this repo's CI — the image carries no GStreamer
 * headers; the C API beneath it is covered by tests/test_capi.py.
 */

#include <gst/gst.h>
#include <gst/video/gstvideoencoder.h>
#include <gst/video/video.h>

#include "capi.h"

GST_DEBUG_CATEGORY_STATIC(gst_svtav1tpuenc_debug);
#define GST_CAT_DEFAULT gst_svtav1tpuenc_debug

#define GST_TYPE_SVTAV1TPUENC (gst_svtav1tpuenc_get_type())
G_DECLARE_FINAL_TYPE(GstSvtAv1TpuEnc, gst_svtav1tpuenc, GST,
                     SVTAV1TPUENC, GstVideoEncoder)

struct _GstSvtAv1TpuEnc {
    GstVideoEncoder parent;
    SvtTpuEncoder *handle;
    SvtTpuConfig cfg;
    GstVideoCodecState *state;
    guint preset;
    gdouble crf;
    guint keyint;
};

G_DEFINE_TYPE(GstSvtAv1TpuEnc, gst_svtav1tpuenc, GST_TYPE_VIDEO_ENCODER)

enum { PROP_0, PROP_PRESET, PROP_CRF, PROP_KEYINT };

static GstStaticPadTemplate sink_template = GST_STATIC_PAD_TEMPLATE(
    "sink", GST_PAD_SINK, GST_PAD_ALWAYS,
    GST_STATIC_CAPS("video/x-raw, format=(string){I420, I420_10LE}, "
                    "width=(int)[64, 4096], height=(int)[64, 2304], "
                    "framerate=(fraction)[0/1, MAX]"));

static GstStaticPadTemplate src_template = GST_STATIC_PAD_TEMPLATE(
    "src", GST_PAD_SRC, GST_PAD_ALWAYS,
    GST_STATIC_CAPS("video/x-av1, stream-format=(string)obu-stream, "
                    "alignment=(string)tu"));

static void gst_svtav1tpuenc_set_property(GObject *object, guint prop_id,
                                          const GValue *value,
                                          GParamSpec *pspec)
{
    GstSvtAv1TpuEnc *enc = GST_SVTAV1TPUENC(object);
    switch (prop_id) {
    case PROP_PRESET: enc->preset = g_value_get_uint(value); break;
    case PROP_CRF: enc->crf = g_value_get_double(value); break;
    case PROP_KEYINT: enc->keyint = g_value_get_uint(value); break;
    default:
        G_OBJECT_WARN_INVALID_PROPERTY_ID(object, prop_id, pspec);
    }
}

static void gst_svtav1tpuenc_get_property(GObject *object, guint prop_id,
                                          GValue *value, GParamSpec *pspec)
{
    GstSvtAv1TpuEnc *enc = GST_SVTAV1TPUENC(object);
    switch (prop_id) {
    case PROP_PRESET: g_value_set_uint(value, enc->preset); break;
    case PROP_CRF: g_value_set_double(value, enc->crf); break;
    case PROP_KEYINT: g_value_set_uint(value, enc->keyint); break;
    default:
        G_OBJECT_WARN_INVALID_PROPERTY_ID(object, prop_id, pspec);
    }
}

static gboolean gst_svtav1tpuenc_set_format(GstVideoEncoder *encoder,
                                            GstVideoCodecState *state)
{
    GstSvtAv1TpuEnc *enc = GST_SVTAV1TPUENC(encoder);
    const GstVideoInfo *info = &state->info;

    if (enc->state)
        gst_video_codec_state_unref(enc->state);
    enc->state = gst_video_codec_state_ref(state);

    if (svt_tpu_enc_init_handle(&enc->handle, &enc->cfg) != SVT_TPU_OK)
        return FALSE;
    enc->cfg.width = GST_VIDEO_INFO_WIDTH(info);
    enc->cfg.height = GST_VIDEO_INFO_HEIGHT(info);
    enc->cfg.bit_depth =
        GST_VIDEO_INFO_FORMAT(info) == GST_VIDEO_FORMAT_I420_10LE ? 10 : 8;
    enc->cfg.enc_mode = enc->preset;
    enc->cfg.crf = enc->crf;
    enc->cfg.intra_period = enc->keyint ? (gint)enc->keyint - 1 : -1;
    if (GST_VIDEO_INFO_FPS_D(info))
        enc->cfg.frame_rate =
            GST_VIDEO_INFO_FPS_N(info) / GST_VIDEO_INFO_FPS_D(info);
    if (svt_tpu_enc_set_parameter(enc->handle, &enc->cfg) != SVT_TPU_OK)
        return FALSE;
    if (svt_tpu_enc_init(enc->handle) != SVT_TPU_OK)
        return FALSE;

    GstVideoCodecState *out = gst_video_encoder_set_output_state(
        encoder,
        gst_caps_from_string("video/x-av1, stream-format=obu-stream, "
                             "alignment=tu"),
        state);
    gst_video_codec_state_unref(out);
    return TRUE;
}

static GstFlowReturn drain_packets(GstSvtAv1TpuEnc *enc)
{
    const guint8 *data;
    size_t size;
    gint64 pts;
    GstFlowReturn ret = GST_FLOW_OK;
    while (svt_tpu_enc_get_packet(enc->handle, &data, &size, &pts) ==
           SVT_TPU_OK) {
        GstVideoCodecFrame *f =
            gst_video_encoder_get_oldest_frame(GST_VIDEO_ENCODER(enc));
        GstBuffer *buf = gst_buffer_new_memdup(data, size);
        if (f) {
            f->output_buffer = buf;
            ret = gst_video_encoder_finish_frame(GST_VIDEO_ENCODER(enc),
                                                 f);
        } else {
            gst_buffer_unref(buf);
        }
        if (ret != GST_FLOW_OK)
            break;
    }
    return ret;
}

static GstFlowReturn
gst_svtav1tpuenc_handle_frame(GstVideoEncoder *encoder,
                              GstVideoCodecFrame *frame)
{
    GstSvtAv1TpuEnc *enc = GST_SVTAV1TPUENC(encoder);
    GstVideoFrame vframe;
    int sample = enc->cfg.bit_depth == 10 ? 2 : 1;

    if (!gst_video_frame_map(&vframe, &enc->state->info,
                             frame->input_buffer, GST_MAP_READ)) {
        gst_video_codec_frame_unref(frame);
        return GST_FLOW_ERROR;
    }
    int rc = svt_tpu_enc_send_picture(
        enc->handle, GST_VIDEO_FRAME_PLANE_DATA(&vframe, 0),
        GST_VIDEO_FRAME_PLANE_STRIDE(&vframe, 0) / sample,
        GST_VIDEO_FRAME_PLANE_DATA(&vframe, 1),
        GST_VIDEO_FRAME_PLANE_DATA(&vframe, 2),
        GST_VIDEO_FRAME_PLANE_STRIDE(&vframe, 1) / sample);
    gst_video_frame_unmap(&vframe);
    gst_video_codec_frame_unref(frame);
    if (rc != SVT_TPU_OK)
        return GST_FLOW_ERROR;
    return drain_packets(enc);
}

static GstFlowReturn gst_svtav1tpuenc_finish(GstVideoEncoder *encoder)
{
    GstSvtAv1TpuEnc *enc = GST_SVTAV1TPUENC(encoder);
    svt_tpu_enc_send_picture(enc->handle, NULL, 0, NULL, NULL, 0);
    return drain_packets(enc);
}

static gboolean gst_svtav1tpuenc_stop(GstVideoEncoder *encoder)
{
    GstSvtAv1TpuEnc *enc = GST_SVTAV1TPUENC(encoder);
    if (enc->handle) {
        svt_tpu_enc_deinit(enc->handle);
        enc->handle = NULL;
    }
    if (enc->state) {
        gst_video_codec_state_unref(enc->state);
        enc->state = NULL;
    }
    return TRUE;
}

static void gst_svtav1tpuenc_class_init(GstSvtAv1TpuEncClass *klass)
{
    GObjectClass *gobject_class = G_OBJECT_CLASS(klass);
    GstElementClass *element_class = GST_ELEMENT_CLASS(klass);
    GstVideoEncoderClass *venc_class = GST_VIDEO_ENCODER_CLASS(klass);

    gobject_class->set_property = gst_svtav1tpuenc_set_property;
    gobject_class->get_property = gst_svtav1tpuenc_get_property;
    g_object_class_install_property(
        gobject_class, PROP_PRESET,
        g_param_spec_uint("preset", "Preset", "encoding preset (0..13)",
                          0, 13, 8, G_PARAM_READWRITE));
    g_object_class_install_property(
        gobject_class, PROP_CRF,
        g_param_spec_double("crf", "CRF", "constant rate factor",
                            0, 70, 35, G_PARAM_READWRITE));
    g_object_class_install_property(
        gobject_class, PROP_KEYINT,
        g_param_spec_uint("keyint", "Keyint", "key frame interval "
                          "(0 = single key)", 0, 65535, 0,
                          G_PARAM_READWRITE));

    gst_element_class_add_static_pad_template(element_class,
                                              &sink_template);
    gst_element_class_add_static_pad_template(element_class,
                                              &src_template);
    gst_element_class_set_static_metadata(
        element_class, "svt-av1-psy-tpu encoder", "Codec/Encoder/Video",
        "AV1 encoder (svt-av1-psy-tpu)", "svt-av1-psy-tpu");

    venc_class->set_format = gst_svtav1tpuenc_set_format;
    venc_class->handle_frame = gst_svtav1tpuenc_handle_frame;
    venc_class->finish = gst_svtav1tpuenc_finish;
    venc_class->stop = gst_svtav1tpuenc_stop;
}

static void gst_svtav1tpuenc_init(GstSvtAv1TpuEnc *enc)
{
    enc->preset = 8;
    enc->crf = 35;
    enc->keyint = 0;
}

static gboolean plugin_init(GstPlugin *plugin)
{
    GST_DEBUG_CATEGORY_INIT(gst_svtav1tpuenc_debug, "svtav1tpuenc", 0,
                            "svt-av1-psy-tpu encoder");
    return gst_element_register(plugin, "svtav1tpuenc", GST_RANK_NONE,
                                GST_TYPE_SVTAV1TPUENC);
}

#ifndef PACKAGE
#define PACKAGE "svtav1tpuenc"
#endif
GST_PLUGIN_DEFINE(GST_VERSION_MAJOR, GST_VERSION_MINOR, svtav1tpuenc,
                  "svt-av1-psy-tpu AV1 encoder", plugin_init, "0.3",
                  "MIT", "svt-av1-psy-tpu", "https://invalid.local")
