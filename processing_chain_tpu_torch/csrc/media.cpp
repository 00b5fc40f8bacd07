// media.cpp — the port's media boundary, bound to libav at run time.
//
// The subset of processing_chain_tpu/native/media.cpp that p01-p04 call
// (probe, packet scans, video decode, stereo audio decode, the encoder with
// its two-pass and frame-parallel FFV1 routes, the Annex-B and IVF
// extraction of p02's frame sizes), with the same C signatures.
// It includes no libav header. `mp_bind` dlopens the libraries that
// io/medialib.py located and resolves every entry point with dlsym, so one
// source serves whichever FFmpeg the host has (5.1 and 8 are tabled). Every
// libav struct stays opaque; a field is reached in one of two ways:
//
//   * through the library's own AVOption table (av_opt_set_*/av_opt_get_*)
//     where the struct has an AVClass: AVCodecContext and AVFormatContext.
//     The AVCodecContext fields without an option are reached from a
//     neighbouring option's offset: coded_width/height right after the
//     "video_size" option's width/height (+ 8), the two-pass statistics
//     stats_out/stats_in right before the "bug" option's field (- 16, - 8);
//   * otherwise through `Layout`, one offset table per (lavu, lavf, lavc)
//     major triple. A triple with no table is refused, never guessed.
//
// `mp_check` proves a bound table before anything else runs: each entry is
// exercised by a round trip with known values (a frame allocated with
// av_frame_get_buffer, a packet rescaled, codec parameters copied from a
// context configured through options, streams created on a muxer, a
// bitstream filter initialised, and a small FFV1+FLAC AVI written and read
// back through the entry points below). The statistics fields are proved
// by a two-pass encode of a small clip with each libvpx/libaom encoder
// bound; an encoder whose round trip fails keeps its two-pass refused by
// name, and no round trip passing refuses two-pass wherever it needs them. Pointer fields are dereferenced during the check only through
// `safe_read`, so a wrong offset fails with the field's name instead of a
// crash.
//
// All functions return 0 (or a count >= 0) on success and a negative
// number on failure; when an `err` buffer is provided the failure reason is
// written into it.

#include <dlfcn.h>
#include <fcntl.h>
#include <unistd.h>

#include <cerrno>
#include <climits>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#define EXPORT extern "C" __attribute__((visibility("default")))

namespace {

// ---------------------------------------------------------------------------
// The public libav types and constants whose ABI is the same in every
// version this file binds (FFmpeg 5.1 through 8).
// ---------------------------------------------------------------------------

struct Rational {
    int num, den;
};

struct ChannelLayout {  // AVChannelLayout
    int order;
    int nb_channels;
    uint64_t mask;
    void* opaque;
};

struct DictEntry {  // AVDictionaryEntry
    char* key;
    char* value;
};

using Ctx = void;  // AVCodecContext
using Fmt = void;  // AVFormatContext
using Stream = void;
using Par = void;  // AVCodecParameters
using Frame = void;
using Packet = void;
using Codec = void;
using Swr = void;
using Dict = void;
using Pb = void;  // AVIOContext
using Bsf = void;  // AVBSFContext

constexpr int64_t NOPTS = INT64_MIN;
constexpr int TIME_BASE = 1000000;
constexpr int MEDIA_VIDEO = 0;
constexpr int MEDIA_AUDIO = 1;
constexpr int PIX_FMT_NONE = -1;
constexpr int SAMPLE_FMT_NONE = -1;
constexpr int SAMPLE_FMT_S16 = 1;
constexpr int PKT_FLAG_KEY = 1;
constexpr int FMT_NOFILE = 0x0001;
constexpr int FMT_GLOBALHEADER = 0x0040;
constexpr int FMT_NOTIMESTAMPS = 0x0080;
constexpr int64_t CODEC_FLAG_PASS1 = 1 << 9;
constexpr int64_t CODEC_FLAG_PASS2 = 1 << 10;
constexpr int64_t CODEC_FLAG_GLOBAL_HEADER = 1 << 22;
constexpr int COMPLIANCE_EXPERIMENTAL = -2;
constexpr int IO_FLAG_WRITE = 2;
constexpr int OPT_SEARCH_CHILDREN = 1;
constexpr int CODEC_CONFIG_SAMPLE_FORMAT = 3;  // AV_CODEC_CONFIG_SAMPLE_FORMAT
constexpr int ERR_EAGAIN = -EAGAIN;
constexpr int ERR_EOF = -static_cast<int>(('E') | ('O' << 8) | ('F' << 16) |
                                          (static_cast<unsigned>(' ') << 24));

int ceil_rshift(int a, int b) { return -((-a) >> b); }

// ---------------------------------------------------------------------------
// Entry points, resolved by mp_bind.
// ---------------------------------------------------------------------------

struct Api {
    // libavutil
    unsigned (*avutil_version)();
    int (*av_strerror)(int, char*, size_t);
    Frame* (*av_frame_alloc)();
    void (*av_frame_free)(Frame**);
    void (*av_frame_unref)(Frame*);
    int (*av_frame_get_buffer)(Frame*, int);
    int (*av_frame_make_writable)(Frame*);
    const char* (*av_get_pix_fmt_name)(int);
    int (*av_get_pix_fmt)(const char*);
    const void* (*av_pix_fmt_desc_get)(int);
    int (*av_pix_fmt_count_planes)(int);
    int (*av_pix_fmt_get_chroma_sub_sample)(int, int*, int*);
    int (*av_image_get_linesize)(int, int, int);
    const char* (*av_get_sample_fmt_name)(int);
    void (*av_channel_layout_default)(ChannelLayout*, int);
    int (*av_channel_layout_copy)(ChannelLayout*, const ChannelLayout*);
    void (*av_channel_layout_uninit)(ChannelLayout*);
    int (*av_opt_set)(void*, const char*, const char*, int);
    int (*av_opt_set_int)(void*, const char*, int64_t, int);
    int (*av_opt_get_int)(void*, const char*, int, int64_t*);
    int (*av_opt_set_q)(void*, const char*, Rational, int);
    int (*av_opt_get_q)(void*, const char*, int, Rational*);
    int (*av_opt_set_image_size)(void*, const char*, int, int, int);
    int (*av_opt_get_image_size)(void*, const char*, int, int*, int*);
    int (*av_opt_set_pixel_fmt)(void*, const char*, int, int);
    int (*av_opt_get_pixel_fmt)(void*, const char*, int, int*);
    int (*av_opt_set_chlayout)(void*, const char*, const ChannelLayout*, int);
    int (*av_opt_get_chlayout)(void*, const char*, int, ChannelLayout*);
    const void* (*av_opt_find2)(void*, const char*, const char*, int, int, void**);
    int (*av_dict_parse_string)(Dict**, const char*, const char*, const char*, int);
    DictEntry* (*av_dict_get)(const Dict*, const char*, const DictEntry*, int);
    int (*av_dict_set)(Dict**, const char*, const char*, int);
    void (*av_dict_free)(Dict**);
    char* (*av_strdup)(const char*);
    void (*av_freep)(void*);
    int (*av_log_get_level)();
    void (*av_log_set_level)(int);
    // libavcodec
    unsigned (*avcodec_version)();
    const Codec* (*avcodec_find_decoder)(int);
    const Codec* (*avcodec_find_decoder_by_name)(const char*);
    const Codec* (*avcodec_find_encoder_by_name)(const char*);
    Ctx* (*avcodec_alloc_context3)(const Codec*);
    void (*avcodec_free_context)(Ctx**);
    int (*avcodec_parameters_to_context)(Ctx*, const Par*);
    int (*avcodec_parameters_from_context)(Par*, const Ctx*);
    int (*avcodec_parameters_copy)(Par*, const Par*);
    Par* (*avcodec_parameters_alloc)();
    void (*avcodec_parameters_free)(Par**);
    int (*avcodec_open2)(Ctx*, const Codec*, Dict**);
    int (*avcodec_send_packet)(Ctx*, const Packet*);
    int (*avcodec_receive_frame)(Ctx*, Frame*);
    int (*avcodec_send_frame)(Ctx*, const Frame*);
    int (*avcodec_receive_packet)(Ctx*, Packet*);
    const char* (*avcodec_get_name)(int);
    const char* (*avcodec_profile_name)(int, int);
    int (*avcodec_get_supported_config)(const Ctx*, const Codec*, int, unsigned,
                                        const void**, int*);  // optional
    Packet* (*av_packet_alloc)();
    void (*av_packet_free)(Packet**);
    void (*av_packet_unref)(Packet*);
    void (*av_packet_rescale_ts)(Packet*, Rational, Rational);
    int (*av_new_packet)(Packet*, int);
    const void* (*av_bsf_get_by_name)(const char*);
    int (*av_bsf_alloc)(const void*, Bsf**);
    int (*av_bsf_init)(Bsf*);
    int (*av_bsf_send_packet)(Bsf*, Packet*);
    int (*av_bsf_receive_packet)(Bsf*, Packet*);
    void (*av_bsf_free)(Bsf**);
    // libavformat
    unsigned (*avformat_version)();
    int (*avformat_open_input)(Fmt**, const char*, const void*, Dict**);
    int (*avformat_find_stream_info)(Fmt*, Dict**);
    void (*avformat_close_input)(Fmt**);
    int (*av_find_best_stream)(Fmt*, int, int, int, const Codec**, int);
    int (*av_read_frame)(Fmt*, Packet*);
    int (*avformat_seek_file)(Fmt*, int, int64_t, int64_t, int64_t, int);
    int (*avformat_alloc_output_context2)(Fmt**, const void*, const char*, const char*);
    void (*avformat_free_context)(Fmt*);
    Stream* (*avformat_new_stream)(Fmt*, const Codec*);
    int (*avio_open)(Pb**, const char*, int);
    int (*avio_closep)(Pb**);
    int64_t (*avio_size)(Pb*);
    int (*avformat_write_header)(Fmt*, Dict**);
    int (*av_interleaved_write_frame)(Fmt*, Packet*);
    int (*av_write_trailer)(Fmt*);
    const void* (*av_guess_format)(const char*, const char*, const char*);
    const void* (*av_find_input_format)(const char*);
    // libswresample
    unsigned (*swresample_version)();
    int (*swr_alloc_set_opts2)(Swr**, const ChannelLayout*, int, int,
                               const ChannelLayout*, int, int, int, void*);
    int (*swr_init)(Swr*);
    int (*swr_convert)(Swr*, uint8_t**, int, const uint8_t**, int);
    void (*swr_free)(Swr**);
};

Api api;
bool g_bound = false;

// ---------------------------------------------------------------------------
// Struct layouts. -1 marks a field this version does not need.
// ---------------------------------------------------------------------------

struct Layout {
    int lavu, lavf, lavc;  // major versions this table is for
    int frame_data, frame_linesize, frame_extended_data, frame_width,
        frame_height, frame_nb_samples, frame_format, frame_pts,
        frame_sample_rate, frame_best_effort_timestamp, frame_ch_layout;
    int pkt_pts, pkt_dts, pkt_data, pkt_size, pkt_stream_index, pkt_flags,
        pkt_duration;
    int fmt_iformat, fmt_oformat, fmt_pb, fmt_nb_streams, fmt_streams,
        fmt_duration, fmt_bit_rate;
    int st_index, st_codecpar, st_time_base, st_duration, st_nb_frames,
        st_avg_frame_rate, st_r_frame_rate;
    int par_codec_type, par_codec_id, par_extradata, par_extradata_size,
        par_format, par_bit_rate, par_profile, par_width, par_height,
        par_ch_layout, par_sample_rate;
    int ofmt_name, ofmt_flags, ifmt_name;
    int desc_log2_chroma_w, desc_log2_chroma_h, desc_comp0_depth;
    int codec_sample_fmts;  // -1 where avcodec_get_supported_config exists
    int bsf_par_in, bsf_time_base_in;
};

// FFmpeg 5.1 (lavu 57, lavf 59, lavc 59): offsetof from its headers, held
// against them by tests/test_torch_media.py.
// FFmpeg 8 (lavu 60, lavf 62, lavc 62): AVFrame lost key_frame, the
// interlace fields, palette_has_changed, reordered_opaque, the old channel
// fields and pkt_pos; AVStream gained a leading av_class and moved codecpar
// up; AVFormatContext gained stream groups and moved chapters up;
// AVCodecParameters gained coded side data and framerate and lost the old
// channel fields. AVBSFContext is the same in both.
const Layout kLayouts[] = {
    {57, 59, 59,
     0, 64, 96, 104, 108, 112, 116, 136, 208, 344, 448,
     8, 16, 24, 32, 36, 40, 64,
     8, 16, 32, 44, 48, 72, 80,
     0, 208, 16, 32, 40, 72, 200,
     0, 4, 16, 24, 28, 32, 48, 56, 60, 144, 116,
     0, 44, 0,
     9, 10, 40,
     56,
     24, 40},
    {60, 62, 62,
     0, 64, 96, 104, 108, 112, 116, 136, 180, 304, 384,
     8, 16, 24, 32, 36, 40, 64,
     8, 16, 32, 44, 48, 104, 112,
     8, 16, 32, 48, 56, 88, 204,
     0, 4, 16, 24, 44, 48, 64, 72, 76, 128, 152,
     0, 44, 0,
     9, 10, 40,
     -1,
     24, 40},
};

const Layout* L = nullptr;

template <class T>
T& field(const void* base, int off) {
    return *reinterpret_cast<T*>(const_cast<char*>(static_cast<const char*>(base)) + off);
}

// AVCodecContext coded_width/coded_height: right after the width/height
// pair the "video_size" option addresses, in every version bound here.
int g_ctx_coded_off = -1;
// AVCodecContext stats_out/stats_in (two-pass statistics, no AVOption):
// the two pointers right before workaround_bugs, the field of the "bug"
// option, in every version bound here. -1 until mp_check's round trip of
// a two-pass encode has proved them.
int g_ctx_stats_out_off = -1;
int g_ctx_stats_in_off = -1;
// What mp_check's two-pass round trips found, "<encoder>=<verdict> ...";
// `twopass_refusal` reads it.
std::string g_twopass;

void set_err(char* err, int errlen, const std::string& msg) {
    if (err && errlen > 0) snprintf(err, (size_t)errlen, "%s", msg.c_str());
}

std::string av_errstr(int code) {
    char buf[128] = {0};
    api.av_strerror(code, buf, sizeof(buf));
    return std::string(buf);
}

double q2d(Rational r) { return r.den ? (double)r.num / (double)r.den : NAN; }

double ts_to_sec(int64_t ts, Rational tb) {
    if (ts == NOPTS) return NAN;
    return ts * q2d(tb);
}

// --- accessors --------------------------------------------------------------

unsigned fmt_nb_streams(Fmt* f) { return field<unsigned>(f, L->fmt_nb_streams); }
Stream* fmt_stream(Fmt* f, unsigned i) { return field<Stream**>(f, L->fmt_streams)[i]; }
int64_t fmt_duration(Fmt* f) { return field<int64_t>(f, L->fmt_duration); }
Par* st_par(Stream* s) { return field<Par*>(s, L->st_codecpar); }
Rational st_tb(Stream* s) { return field<Rational>(s, L->st_time_base); }
int st_index(Stream* s) { return field<int>(s, L->st_index); }
int ofmt_flags(Fmt* f) { return field<int>(field<const void*>(f, L->fmt_oformat), L->ofmt_flags); }

double stream_duration(Fmt* f, Stream* st) {
    int64_t d = field<int64_t>(st, L->st_duration);
    if (d != NOPTS) return ts_to_sec(d, st_tb(st));
    int64_t fd = fmt_duration(f);
    return fd != NOPTS ? (double)fd / TIME_BASE : 0.0;
}

uint8_t** frame_data(Frame* fr) { return &field<uint8_t*>(fr, L->frame_data); }
int* frame_linesize(Frame* fr) { return &field<int>(fr, L->frame_linesize); }

int64_t ctx_int(void* c, const char* name) {
    int64_t v = 0;
    api.av_opt_get_int(c, name, 0, &v);
    return v;
}

int ctx_pix_fmt(Ctx* c) {
    int pf = PIX_FMT_NONE;
    api.av_opt_get_pixel_fmt(c, "pixel_format", 0, &pf);
    return pf;
}

void ctx_size(Ctx* c, int* w, int* h) {
    *w = *h = 0;
    api.av_opt_get_image_size(c, "video_size", 0, w, h);
}

int ctx_channels(Ctx* c) {
    ChannelLayout cl{};
    if (api.av_opt_get_chlayout(c, "ch_layout", 0, &cl) < 0) return 0;
    int n = cl.nb_channels;
    api.av_channel_layout_uninit(&cl);
    return n;
}

int desc_log2_w(const void* d) { return field<uint8_t>(d, L->desc_log2_chroma_w); }
int desc_log2_h(const void* d) { return field<uint8_t>(d, L->desc_log2_chroma_h); }
int desc_depth(const void* d) { return field<int>(d, L->desc_comp0_depth); }

// Reads n bytes at addr without faulting: the kernel copies them into a
// pipe and refuses an unmapped address with EFAULT. Only the layout check
// uses it, before a pointer field's offset is trusted.
bool safe_read(const void* addr, void* out, size_t n) {
    if (!addr) return false;
    int fds[2];
    if (pipe(fds) != 0) return false;
    bool ok = write(fds[1], addr, n) == (ssize_t)n &&
              read(fds[0], out, n) == (ssize_t)n;
    close(fds[0]);
    close(fds[1]);
    return ok;
}

template <class T>
bool safe_field(const void* base, int off, T* out) {
    return safe_read(static_cast<const char*>(base) + off, out, sizeof(T));
}

}  // namespace

// ---------------------------------------------------------------------------
// Binding
// ---------------------------------------------------------------------------

// paths: the libraries to dlopen (RTLD_GLOBAL, in order). Symbols are looked
// up in each handle in turn. Returns 0, or -1 with the missing symbol or the
// unsupported version triple in err.
EXPORT int mp_bind(const char* const* paths, int n, char* err, int errlen) {
    if (g_bound) return 0;
    std::vector<void*> handles;
    for (int i = 0; i < n; i++) {
        void* h = dlopen(paths[i], RTLD_NOW | RTLD_GLOBAL);
        if (!h) {
            set_err(err, errlen, std::string("dlopen ") + paths[i] + ": " + dlerror());
            return -1;
        }
        handles.push_back(h);
    }
    std::string missing;
    auto resolve = [&](const char* name, bool required) -> void* {
        for (void* h : handles)
            if (void* p = dlsym(h, name)) return p;
        if (required) missing += (missing.empty() ? "" : ", ") + std::string(name);
        return nullptr;
    };
#define R(name) api.name = reinterpret_cast<decltype(api.name)>(resolve(#name, true))
#define R_OPT(name) api.name = reinterpret_cast<decltype(api.name)>(resolve(#name, false))
    R(avutil_version); R(av_strerror); R(av_frame_alloc); R(av_frame_free);
    R(av_frame_unref); R(av_frame_get_buffer); R(av_frame_make_writable);
    R(av_get_pix_fmt_name); R(av_get_pix_fmt); R(av_pix_fmt_desc_get);
    R(av_pix_fmt_count_planes); R(av_pix_fmt_get_chroma_sub_sample);
    R(av_image_get_linesize); R(av_get_sample_fmt_name);
    R(av_channel_layout_default); R(av_channel_layout_copy);
    R(av_channel_layout_uninit); R(av_opt_set); R(av_opt_set_int);
    R(av_opt_get_int); R(av_opt_set_q); R(av_opt_get_q);
    R(av_opt_set_image_size); R(av_opt_get_image_size);
    R(av_opt_set_pixel_fmt); R(av_opt_get_pixel_fmt); R(av_opt_set_chlayout);
    R(av_opt_get_chlayout); R(av_opt_find2); R(av_dict_parse_string);
    R(av_dict_get); R(av_dict_set); R(av_dict_free); R(av_strdup); R(av_freep);
    R(av_log_get_level); R(av_log_set_level);
    R(avcodec_version); R(avcodec_find_decoder); R(avcodec_find_decoder_by_name);
    R(avcodec_find_encoder_by_name); R(avcodec_alloc_context3);
    R(avcodec_free_context); R(avcodec_parameters_to_context);
    R(avcodec_parameters_from_context); R(avcodec_parameters_copy); R(avcodec_parameters_alloc);
    R(avcodec_parameters_free); R(avcodec_open2); R(avcodec_send_packet);
    R(avcodec_receive_frame); R(avcodec_send_frame); R(avcodec_receive_packet);
    R(avcodec_get_name); R(avcodec_profile_name); R_OPT(avcodec_get_supported_config);
    R(av_packet_alloc); R(av_packet_free); R(av_packet_unref);
    R(av_packet_rescale_ts); R(av_new_packet);
    R(av_bsf_get_by_name); R(av_bsf_alloc); R(av_bsf_init); R(av_bsf_send_packet);
    R(av_bsf_receive_packet); R(av_bsf_free);
    R(avformat_version); R(avformat_open_input); R(avformat_find_stream_info);
    R(avformat_close_input); R(av_find_best_stream); R(av_read_frame);
    R(avformat_seek_file); R(avformat_alloc_output_context2);
    R(avformat_free_context); R(avformat_new_stream); R(avio_open);
    R(avio_closep); R(avio_size); R(avformat_write_header);
    R(av_interleaved_write_frame); R(av_write_trailer); R(av_guess_format);
    R(av_find_input_format);
    R(swresample_version); R(swr_alloc_set_opts2); R(swr_init); R(swr_convert);
    R(swr_free);
#undef R
#undef R_OPT
    if (!missing.empty()) {
        set_err(err, errlen, "libav entry points not found: " + missing);
        return -1;
    }
    int u = (int)(api.avutil_version() >> 16), f = (int)(api.avformat_version() >> 16),
        c = (int)(api.avcodec_version() >> 16);
    for (const Layout& lay : kLayouts)
        if (lay.lavu == u && lay.lavf == f && lay.lavc == c) L = &lay;
    if (!L) {
        std::string known;
        for (const Layout& lay : kLayouts)
            known += " " + std::to_string(lay.lavu) + "/" + std::to_string(lay.lavf) +
                     "/" + std::to_string(lay.lavc);
        set_err(err, errlen,
                "no struct layout for lavu/lavf/lavc " + std::to_string(u) + "/" +
                    std::to_string(f) + "/" + std::to_string(c) + " (tabled:" + known + ")");
        return -1;
    }
    if (L->codec_sample_fmts < 0 && !api.avcodec_get_supported_config) {
        set_err(err, errlen, "avcodec_get_supported_config not found and no AVCodec.sample_fmts offset");
        return -1;
    }
    g_bound = true;
    return 0;
}

EXPORT const char* mp_version() {
    static char buf[160];
    if (!g_bound) return "unbound";
    auto v = [](unsigned x) {
        return std::to_string(x >> 16) + "." + std::to_string((x >> 8) & 0xFF) + "." +
               std::to_string(x & 0xFF);
    };
    snprintf(buf, sizeof(buf), "lavu %s lavf %s lavc %s swr %s",
             v(api.avutil_version()).c_str(), v(api.avformat_version()).c_str(),
             v(api.avcodec_version()).c_str(), v(api.swresample_version()).c_str());
    return buf;
}

// The offset the bound table gives `name` ("AVFrame.pts", ...), -1 when the
// name is unknown or the version does not use it, -2 when nothing is bound.
EXPORT int mp_layout(const char* name) {
    if (!L) return -2;
    struct E { const char* n; int v; };
    const E table[] = {
        {"AVFrame.data", L->frame_data}, {"AVFrame.linesize", L->frame_linesize},
        {"AVFrame.extended_data", L->frame_extended_data}, {"AVFrame.width", L->frame_width},
        {"AVFrame.height", L->frame_height}, {"AVFrame.nb_samples", L->frame_nb_samples},
        {"AVFrame.format", L->frame_format}, {"AVFrame.pts", L->frame_pts},
        {"AVFrame.sample_rate", L->frame_sample_rate},
        {"AVFrame.best_effort_timestamp", L->frame_best_effort_timestamp},
        {"AVFrame.ch_layout", L->frame_ch_layout},
        {"AVPacket.pts", L->pkt_pts}, {"AVPacket.dts", L->pkt_dts},
        {"AVPacket.data", L->pkt_data}, {"AVPacket.size", L->pkt_size},
        {"AVPacket.stream_index", L->pkt_stream_index}, {"AVPacket.flags", L->pkt_flags},
        {"AVPacket.duration", L->pkt_duration},
        {"AVFormatContext.iformat", L->fmt_iformat}, {"AVFormatContext.oformat", L->fmt_oformat},
        {"AVFormatContext.pb", L->fmt_pb}, {"AVFormatContext.nb_streams", L->fmt_nb_streams},
        {"AVFormatContext.streams", L->fmt_streams}, {"AVFormatContext.duration", L->fmt_duration},
        {"AVFormatContext.bit_rate", L->fmt_bit_rate},
        {"AVStream.index", L->st_index}, {"AVStream.codecpar", L->st_codecpar},
        {"AVStream.time_base", L->st_time_base}, {"AVStream.duration", L->st_duration},
        {"AVStream.nb_frames", L->st_nb_frames}, {"AVStream.avg_frame_rate", L->st_avg_frame_rate},
        {"AVStream.r_frame_rate", L->st_r_frame_rate},
        {"AVCodecParameters.codec_type", L->par_codec_type},
        {"AVCodecParameters.codec_id", L->par_codec_id},
        {"AVCodecParameters.extradata", L->par_extradata},
        {"AVCodecParameters.extradata_size", L->par_extradata_size},
        {"AVCodecParameters.format", L->par_format}, {"AVCodecParameters.bit_rate", L->par_bit_rate},
        {"AVCodecParameters.profile", L->par_profile}, {"AVCodecParameters.width", L->par_width},
        {"AVCodecParameters.height", L->par_height}, {"AVCodecParameters.ch_layout", L->par_ch_layout},
        {"AVCodecParameters.sample_rate", L->par_sample_rate},
        {"AVOutputFormat.name", L->ofmt_name}, {"AVOutputFormat.flags", L->ofmt_flags},
        {"AVInputFormat.name", L->ifmt_name},
        {"AVPixFmtDescriptor.log2_chroma_w", L->desc_log2_chroma_w},
        {"AVPixFmtDescriptor.log2_chroma_h", L->desc_log2_chroma_h},
        {"AVPixFmtDescriptor.comp0_depth", L->desc_comp0_depth},
        {"AVCodec.sample_fmts", L->codec_sample_fmts},
        {"AVBSFContext.par_in", L->bsf_par_in},
        {"AVBSFContext.time_base_in", L->bsf_time_base_in},
    };
    for (const E& e : table)
        if (strcmp(e.n, name) == 0) return e.v;
    return -1;
}

// Whether the bound libav has a decoder (encoder = 0) or an encoder
// (encoder = 1) named `name`: 1 or 0, -1 before mp_bind.
// Whether the bound libav has the bitstream filter `name`: 1 or 0, -1 before
// mp_bind.
EXPORT int mp_has_bsf(const char* name) {
    if (!g_bound) return -1;
    return api.av_bsf_get_by_name(name) != nullptr;
}

// What the two-pass round trips at load found: "<encoder>=<verdict> ..."
// ("ok", "absent", or what failed), "" before mp_check.
EXPORT const char* mp_twopass_report() { return g_twopass.c_str(); }

EXPORT int mp_has_codec(const char* name, int encoder) {
    if (!g_bound) return -1;
    return (encoder ? api.avcodec_find_encoder_by_name(name)
                    : api.avcodec_find_decoder_by_name(name)) != nullptr;
}

// ---------------------------------------------------------------------------
// Probing
// ---------------------------------------------------------------------------

struct MPStreamInfo {
    int32_t stream_index;
    int32_t codec_type;  // 0 video, 1 audio
    char codec_name[32];
    int32_t width, height;
    int32_t coded_width, coded_height;  // decoder coded dims (mb-aligned)
    char pix_fmt[32];
    int32_t fps_num, fps_den;        // r_frame_rate
    int32_t avg_fps_num, avg_fps_den;
    int32_t tb_num, tb_den;          // stream time base
    double duration;                 // seconds (stream, else container)
    int64_t nb_frames;               // container-reported, 0 if unknown
    int64_t bit_rate;                // stream bitrate, 0 if unknown
    int32_t sample_rate;             // audio
    int32_t channels;                // audio
    char sample_fmt[32];             // audio
    char profile[64];                // codec profile name ("" if unknown)
};

struct MPFormatInfo {
    char format_name[64];
    double duration;    // container duration seconds
    int64_t bit_rate;
    int64_t file_size;
    int32_t nb_streams;
};

EXPORT int mp_stream_info_size(void) { return (int)sizeof(MPStreamInfo); }

static int open_input(Fmt** fmt, const char* path, char* err, int errlen) {
    int ret = api.avformat_open_input(fmt, path, nullptr, nullptr);
    if (ret < 0) {
        set_err(err, errlen, "open_input: " + av_errstr(ret));
        return -1;
    }
    if ((ret = api.avformat_find_stream_info(*fmt, nullptr)) < 0) {
        set_err(err, errlen, "find_stream_info: " + av_errstr(ret));
        api.avformat_close_input(fmt);
        return -1;
    }
    return 0;
}

EXPORT int mp_probe(const char* path, MPFormatInfo* fmt_out,
                    MPStreamInfo* streams_out, int max_streams,
                    int want_coded_dims, char* err, int errlen) {
    Fmt* fmt = nullptr;
    if (open_input(&fmt, path, err, errlen) < 0) return -1;
    if (fmt_out) {
        memset(fmt_out, 0, sizeof(*fmt_out));
        const void* ifmt = field<const void*>(fmt, L->fmt_iformat);
        snprintf(fmt_out->format_name, sizeof(fmt_out->format_name), "%s",
                 ifmt ? field<const char*>(ifmt, L->ifmt_name) : "?");
        int64_t d = fmt_duration(fmt);
        fmt_out->duration = d != NOPTS ? (double)d / TIME_BASE : 0.0;
        fmt_out->bit_rate = field<int64_t>(fmt, L->fmt_bit_rate);
        Pb* pb = field<Pb*>(fmt, L->fmt_pb);
        fmt_out->file_size = pb ? api.avio_size(pb) : 0;
        fmt_out->nb_streams = (int32_t)fmt_nb_streams(fmt);
    }
    int n = 0;
    for (unsigned i = 0; i < fmt_nb_streams(fmt) && n < max_streams; i++) {
        Stream* st = fmt_stream(fmt, i);
        Par* par = st_par(st);
        int ctype = field<int>(par, L->par_codec_type);
        if (ctype != MEDIA_VIDEO && ctype != MEDIA_AUDIO) continue;
        int codec_id = field<int>(par, L->par_codec_id);
        MPStreamInfo* si = &streams_out[n++];
        memset(si, 0, sizeof(*si));
        si->stream_index = (int32_t)i;
        si->codec_type = ctype == MEDIA_VIDEO ? 0 : 1;
        const char* cname = api.avcodec_get_name(codec_id);
        snprintf(si->codec_name, sizeof(si->codec_name), "%s", cname ? cname : "?");
        si->width = field<int>(par, L->par_width);
        si->height = field<int>(par, L->par_height);
        int format = field<int>(par, L->par_format);
        if (ctype == MEDIA_VIDEO) {
            const char* pf = api.av_get_pix_fmt_name(format);
            snprintf(si->pix_fmt, sizeof(si->pix_fmt), "%s", pf ? pf : "?");
            si->coded_width = si->width;
            si->coded_height = si->height;
            Rational r = field<Rational>(st, L->st_r_frame_rate);
            Rational a = field<Rational>(st, L->st_avg_frame_rate);
            si->fps_num = r.num;
            si->fps_den = r.den;
            si->avg_fps_num = a.num;
            si->avg_fps_den = a.den;
        } else {
            si->sample_rate = field<int>(par, L->par_sample_rate);
            si->channels = field<ChannelLayout>(par, L->par_ch_layout).nb_channels;
            const char* sf = api.av_get_sample_fmt_name(format);
            snprintf(si->sample_fmt, sizeof(si->sample_fmt), "%s", sf ? sf : "?");
        }
        Rational tb = st_tb(st);
        si->tb_num = tb.num;
        si->tb_den = tb.den;
        si->duration = stream_duration(fmt, st);
        si->nb_frames = field<int64_t>(st, L->st_nb_frames);
        si->bit_rate = field<int64_t>(par, L->par_bit_rate);
        const char* prof = api.avcodec_profile_name(codec_id, field<int>(par, L->par_profile));
        snprintf(si->profile, sizeof(si->profile), "%s", prof ? prof : "");
    }

    // Coded-dims pass (opt-in: a decoder open + first-frame decode), as
    // the JAX boundary does it: first video stream only.
    for (int k = 0; want_coded_dims && k < n; k++) {
        if (streams_out[k].codec_type != 0) continue;
        int si_idx = streams_out[k].stream_index;
        Par* par = st_par(fmt_stream(fmt, (unsigned)si_idx));
        const Codec* cdec = api.avcodec_find_decoder(field<int>(par, L->par_codec_id));
        if (!cdec) break;
        Ctx* cctx = api.avcodec_alloc_context3(cdec);
        if (!cctx) break;
        if (api.avcodec_parameters_to_context(cctx, par) < 0 ||
            api.avcodec_open2(cctx, cdec, nullptr) < 0) {
            api.avcodec_free_context(&cctx);
            break;
        }
        Packet* pkt = api.av_packet_alloc();
        Frame* frm = api.av_frame_alloc();
        int fed = 0;
        bool got = false;
        while (pkt && frm && !got && fed < 64 && api.av_read_frame(fmt, pkt) >= 0) {
            if (field<int>(pkt, L->pkt_stream_index) == si_idx) {
                fed++;
                if (api.avcodec_send_packet(cctx, pkt) >= 0 &&
                    api.avcodec_receive_frame(cctx, frm) >= 0)
                    got = true;
            }
            api.av_packet_unref(pkt);
        }
        if (pkt && frm && !got) {
            api.avcodec_send_packet(cctx, nullptr);
            if (api.avcodec_receive_frame(cctx, frm) >= 0) got = true;
        }
        int cw = field<int>(cctx, g_ctx_coded_off), ch = field<int>(cctx, g_ctx_coded_off + 4);
        if (got && cw > 0) {
            streams_out[k].coded_width = cw;
            streams_out[k].coded_height = ch;
        }
        api.av_frame_free(&frm);
        api.av_packet_free(&pkt);
        api.avcodec_free_context(&cctx);
        break;
    }
    api.avformat_close_input(&fmt);
    return n;
}

// ---------------------------------------------------------------------------
// Packet scans
// ---------------------------------------------------------------------------

namespace {

void record_packet(Packet* pkt, Rational tb, long i, int64_t* sizes, double* pts,
                   double* dts, double* dur, int8_t* key) {
    sizes[i] = field<int>(pkt, L->pkt_size);
    pts[i] = ts_to_sec(field<int64_t>(pkt, L->pkt_pts), tb);
    dts[i] = ts_to_sec(field<int64_t>(pkt, L->pkt_dts), tb);
    int64_t d = field<int64_t>(pkt, L->pkt_duration);
    dur[i] = d > 0 ? d * q2d(tb) : NAN;
    key[i] = (field<int>(pkt, L->pkt_flags) & PKT_FLAG_KEY) ? 1 : 0;
}

}  // namespace

EXPORT long mp_scan_packets(const char* path, int codec_type /*0 v, 1 a*/,
                            int64_t* sizes, double* pts_time, double* dts_time,
                            double* dur_time, int8_t* keyflags, long cap,
                            char* err, int errlen) {
    Fmt* fmt = nullptr;
    if (open_input(&fmt, path, err, errlen) < 0) return -1;
    int want = codec_type == 0 ? MEDIA_VIDEO : MEDIA_AUDIO;
    int sidx = api.av_find_best_stream(fmt, want, -1, -1, nullptr, 0);
    if (sidx < 0) {
        set_err(err, errlen, "no such stream");
        api.avformat_close_input(&fmt);
        return -2;
    }
    Rational tb = st_tb(fmt_stream(fmt, (unsigned)sidx));
    Packet* pkt = api.av_packet_alloc();
    long n = 0;
    while (api.av_read_frame(fmt, pkt) >= 0) {
        if (field<int>(pkt, L->pkt_stream_index) == sidx) {
            if (n < cap) record_packet(pkt, tb, n, sizes, pts_time, dts_time, dur_time, keyflags);
            n++;
        }
        api.av_packet_unref(pkt);
    }
    api.av_packet_free(&pkt);
    api.avformat_close_input(&fmt);
    return n;  // may exceed cap: caller re-allocates and re-scans
}

EXPORT int mp_scan_packets_all(
    const char* path,
    int64_t* v_sizes, double* v_pts, double* v_dts, double* v_dur,
    int8_t* v_key, long v_cap, long* n_video,
    int64_t* a_sizes, double* a_pts, double* a_dts, double* a_dur,
    int8_t* a_key, long a_cap, long* n_audio,
    char* err, int errlen) {
    Fmt* fmt = nullptr;
    if (open_input(&fmt, path, err, errlen) < 0) return -1;
    int vidx = api.av_find_best_stream(fmt, MEDIA_VIDEO, -1, -1, nullptr, 0);
    if (vidx < 0) {
        set_err(err, errlen, "no such stream");
        api.avformat_close_input(&fmt);
        return -2;
    }
    int aidx = api.av_find_best_stream(fmt, MEDIA_AUDIO, -1, -1, nullptr, 0);
    Rational vtb = st_tb(fmt_stream(fmt, (unsigned)vidx));
    Rational atb = aidx >= 0 ? st_tb(fmt_stream(fmt, (unsigned)aidx)) : Rational{1, 1};
    Packet* pkt = api.av_packet_alloc();
    long nv = 0, na = 0;
    while (api.av_read_frame(fmt, pkt) >= 0) {
        int si = field<int>(pkt, L->pkt_stream_index);
        if (si == vidx) {
            if (nv < v_cap) record_packet(pkt, vtb, nv, v_sizes, v_pts, v_dts, v_dur, v_key);
            nv++;
        } else if (aidx >= 0 && si == aidx) {
            if (na < a_cap) record_packet(pkt, atb, na, a_sizes, a_pts, a_dts, a_dur, a_key);
            na++;
        }
        api.av_packet_unref(pkt);
    }
    api.av_packet_free(&pkt);
    api.avformat_close_input(&fmt);
    *n_video = nv;
    *n_audio = aidx >= 0 ? na : -1;
    return 0;
}

// ---------------------------------------------------------------------------
// Video decoding
// ---------------------------------------------------------------------------

struct MPDecoder {
    Fmt* fmt = nullptr;
    Ctx* dec = nullptr;
    int sidx = -1;
    Packet* pkt = nullptr;
    Frame* frame = nullptr;
    bool draining = false;
    double start_s = 0.0, end_s = -1.0;  // trim window; end < 0 = unbounded
    // plane geometry the caller's buffers were sized with (open time)
    int buf_rows[4] = {0, 0, 0, 0};
    int buf_row_bytes[4] = {0, 0, 0, 0};
    int open_w = 0, open_h = 0;
    int open_fmt = PIX_FMT_NONE;
};

struct MPVideoDesc {
    int32_t width, height;
    char pix_fmt[32];
    int32_t fps_num, fps_den;
    double duration;
    int32_t planes;             // number of planes
    int32_t plane_w[4], plane_h[4];
    int32_t bytes_per_sample;   // 1 or 2
};

// Exact byte width of one row of plane p at the given pixel width.
static int plane_row_bytes(int pf, int width, int p, const void* desc, int bps) {
    int lsz = api.av_image_get_linesize(pf, width, p);
    if (lsz > 0) return lsz;
    int pw = (p == 1 || p == 2) ? ceil_rshift(width, desc_log2_w(desc)) : width;
    return pw * bps;
}

static int fill_video_desc(MPDecoder* d, MPVideoDesc* out) {
    memset(out, 0, sizeof(*out));
    int w, h;
    ctx_size(d->dec, &w, &h);
    out->width = w;
    out->height = h;
    int pf = ctx_pix_fmt(d->dec);
    const char* pfn = api.av_get_pix_fmt_name(pf);
    snprintf(out->pix_fmt, sizeof(out->pix_fmt), "%s", pfn ? pfn : "?");
    Stream* st = fmt_stream(d->fmt, (unsigned)d->sidx);
    Rational r = field<Rational>(st, L->st_r_frame_rate);
    out->fps_num = r.num;
    out->fps_den = r.den;
    out->duration = stream_duration(d->fmt, st);
    const void* desc = api.av_pix_fmt_desc_get(pf);
    if (!desc) return -1;
    int planes = api.av_pix_fmt_count_planes(pf);
    out->planes = planes;
    out->bytes_per_sample = desc_depth(desc) > 8 ? 2 : 1;
    for (int p = 0; p < planes && p < 4; p++) {
        int is_chroma = (p == 1 || p == 2);
        out->plane_w[p] = plane_row_bytes(pf, w, p, desc, out->bytes_per_sample) /
                          out->bytes_per_sample;
        out->plane_h[p] = is_chroma ? ceil_rshift(h, desc_log2_h(desc)) : h;
    }
    return 0;
}

EXPORT MPDecoder* mp_decoder_open_t(const char* path, double start_s,
                                    double dur_s, int threads, char* err,
                                    int errlen) {
    auto* d = new MPDecoder();
    if (open_input(&d->fmt, path, err, errlen) < 0) {
        delete d;
        return nullptr;
    }
    const Codec* codec = nullptr;
    d->sidx = api.av_find_best_stream(d->fmt, MEDIA_VIDEO, -1, -1, &codec, 0);
    if (d->sidx < 0 || !codec) {
        set_err(err, errlen, "no video stream");
        api.avformat_close_input(&d->fmt);
        delete d;
        return nullptr;
    }
    Stream* st = fmt_stream(d->fmt, (unsigned)d->sidx);
    d->dec = api.avcodec_alloc_context3(codec);
    api.avcodec_parameters_to_context(d->dec, st_par(st));
    api.av_opt_set_int(d->dec, "threads", threads >= 0 ? threads : 0, 0);
    int ret = api.avcodec_open2(d->dec, codec, nullptr);
    if (ret < 0) {
        set_err(err, errlen, "avcodec_open2: " + av_errstr(ret));
        api.avcodec_free_context(&d->dec);
        api.avformat_close_input(&d->fmt);
        delete d;
        return nullptr;
    }
    d->pkt = api.av_packet_alloc();
    d->frame = api.av_frame_alloc();
    MPVideoDesc vd;
    if (fill_video_desc(d, &vd) == 0) {
        for (int p = 0; p < vd.planes && p < 4; p++) {
            d->buf_rows[p] = vd.plane_h[p];
            d->buf_row_bytes[p] = vd.plane_w[p] * vd.bytes_per_sample;
        }
    }
    ctx_size(d->dec, &d->open_w, &d->open_h);
    d->open_fmt = ctx_pix_fmt(d->dec);
    d->start_s = start_s > 0 ? start_s : 0.0;
    d->end_s = dur_s > 0 ? d->start_s + dur_s : -1.0;
    if (d->start_s > 0) {
        // seek to the keyframe at/before start; earlier frames are dropped
        // in decoder_next_into (accurate-seek semantics)
        int64_t ts = (int64_t)(d->start_s / q2d(st_tb(st)));
        api.avformat_seek_file(d->fmt, d->sidx, INT64_MIN, ts, ts, 0);
    }
    return d;
}

EXPORT int mp_decoder_desc(MPDecoder* d, MPVideoDesc* out) {
    return fill_video_desc(d, out);
}

// Decode the next frame inside the trim window into caller-provided plane
// buffers. Returns 1 on frame, 0 on EOF, < 0 on error.
static int decoder_next_into(MPDecoder* d, uint8_t* planes[4], double* pts_out,
                             char* err, int errlen) {
    Rational tb = st_tb(fmt_stream(d->fmt, (unsigned)d->sidx));
    Frame* fr = d->frame;
    for (;;) {
        int ret = api.avcodec_receive_frame(d->dec, fr);
        if (ret == 0) {
            int64_t be = field<int64_t>(fr, L->frame_best_effort_timestamp);
            double pts = ts_to_sec(be != NOPTS ? be : field<int64_t>(fr, L->frame_pts), tb);
            if (!std::isnan(pts) && pts < d->start_s - 1e-9) {
                api.av_frame_unref(fr);
                continue;  // pre-roll frame before trim start
            }
            if (d->end_s > 0 && !std::isnan(pts) && pts >= d->end_s - 1e-9) {
                api.av_frame_unref(fr);
                return 0;  // past trim end
            }
            int fw = field<int>(fr, L->frame_width), fh = field<int>(fr, L->frame_height);
            int ff = field<int>(fr, L->frame_format);
            if (fw != d->open_w || fh != d->open_h || ff != d->open_fmt) {
                set_err(err, errlen,
                        "mid-stream parameter switch: frame " + std::to_string(fw) + "x" +
                            std::to_string(fh) + " differs from open-time " +
                            std::to_string(d->open_w) + "x" + std::to_string(d->open_h));
                api.av_frame_unref(fr);
                return -1;
            }
            const void* fdesc = api.av_pix_fmt_desc_get(ff);
            int nplanes = api.av_pix_fmt_count_planes(ff);
            uint8_t** data = frame_data(fr);
            int* linesize = frame_linesize(fr);
            for (int p = 0; p < nplanes && p < 4; p++) {
                if (!planes[p]) continue;
                int is_chroma = (p == 1 || p == 2);
                int fr_rows = is_chroma ? ceil_rshift(fh, desc_log2_h(fdesc)) : fh;
                int rows = d->buf_rows[p] < fr_rows ? d->buf_rows[p] : fr_rows;
                int row_bytes = d->buf_row_bytes[p];
                int ls = linesize[p];
                int fr_bytes = plane_row_bytes(ff, fw, p, fdesc, desc_depth(fdesc) > 8 ? 2 : 1);
                int copy = fr_bytes < row_bytes ? fr_bytes : row_bytes;
                if (ls <= 0) {
                    set_err(err, errlen,
                            "decoder produced non-positive linesize " + std::to_string(ls) +
                                " on plane " + std::to_string(p));
                    api.av_frame_unref(fr);
                    return -1;
                }
                if (ls < copy) copy = ls;
                for (int y = 0; y < rows; y++)
                    memcpy(planes[p] + (size_t)y * row_bytes, data[p] + (size_t)y * (size_t)ls,
                           (size_t)copy);
            }
            if (pts_out) *pts_out = pts;
            api.av_frame_unref(fr);
            return 1;
        }
        if (ret == ERR_EOF) return 0;
        if (ret != ERR_EAGAIN) {
            set_err(err, errlen, "receive_frame: " + av_errstr(ret));
            return -1;
        }
        if (d->draining) return 0;
        if (api.av_read_frame(d->fmt, d->pkt) < 0) {
            d->draining = true;
            api.avcodec_send_packet(d->dec, nullptr);
            continue;
        }
        if (field<int>(d->pkt, L->pkt_stream_index) == d->sidx) {
            int sret = api.avcodec_send_packet(d->dec, d->pkt);
            if (sret < 0 && sret != ERR_EAGAIN) {
                api.av_packet_unref(d->pkt);
                set_err(err, errlen, "send_packet: " + av_errstr(sret));
                return -1;
            }
        }
        api.av_packet_unref(d->pkt);
    }
}

EXPORT int mp_decoder_next(MPDecoder* d, uint8_t* p0, uint8_t* p1, uint8_t* p2,
                           uint8_t* p3, double* pts_out, char* err, int errlen) {
    uint8_t* planes[4] = {p0, p1, p2, p3};
    return decoder_next_into(d, planes, pts_out, err, errlen);
}

// Up to `max_frames` frames in ONE call into caller-provided contiguous
// plane blocks laid out [N, plane_h, plane_w] (open-time geometry).
EXPORT long mp_decoder_next_batch(MPDecoder* d, uint8_t* p0, uint8_t* p1,
                                  uint8_t* p2, uint8_t* p3, long max_frames,
                                  double* pts_out, char* err, int errlen) {
    uint8_t* bases[4] = {p0, p1, p2, p3};
    size_t fsize[4];
    for (int p = 0; p < 4; p++) fsize[p] = (size_t)d->buf_rows[p] * (size_t)d->buf_row_bytes[p];
    long n = 0;
    while (n < max_frames) {
        uint8_t* planes[4];
        for (int p = 0; p < 4; p++) planes[p] = bases[p] ? bases[p] + (size_t)n * fsize[p] : nullptr;
        double pts = 0.0;
        int ret = decoder_next_into(d, planes, &pts, err, errlen);
        if (ret < 0) return ret;
        if (ret == 0) break;
        if (pts_out) pts_out[n] = pts;
        n++;
    }
    return n;
}

EXPORT void mp_decoder_close(MPDecoder* d) {
    if (!d) return;
    api.av_packet_free(&d->pkt);
    api.av_frame_free(&d->frame);
    api.avcodec_free_context(&d->dec);
    api.avformat_close_input(&d->fmt);
    delete d;
}

// ---------------------------------------------------------------------------
// Audio decoding
// ---------------------------------------------------------------------------

// Decodes the best audio stream to interleaved s16 within [start_s,
// start_s+dur_s). Two-phase: call with buf == nullptr for the sample count
// (per channel), then with a buffer of samples*channels*2 bytes.
// out_channels > 0 remixes to that count's default layout inside
// libswresample (the ffmpeg CLI's `-ac N`); 0 keeps the native layout. The
// resampler takes its input format and layout from the first kept frame
// (the context's sample_fmt has no AVOption).
EXPORT long mp_decode_audio_s16_ch(const char* path, double start_s,
                                   double dur_s, int out_channels,
                                   int16_t* buf, long buf_samples,
                                   int32_t* sample_rate_out,
                                   int32_t* channels_out, char* err,
                                   int errlen) {
    Fmt* fmt = nullptr;
    if (open_input(&fmt, path, err, errlen) < 0) return -1;
    const Codec* codec = nullptr;
    int sidx = api.av_find_best_stream(fmt, MEDIA_AUDIO, -1, -1, &codec, 0);
    if (sidx < 0 || !codec) {
        set_err(err, errlen, "no audio stream");
        api.avformat_close_input(&fmt);
        return -2;
    }
    Stream* st = fmt_stream(fmt, (unsigned)sidx);
    Ctx* dec = api.avcodec_alloc_context3(codec);
    api.avcodec_parameters_to_context(dec, st_par(st));
    int ret = api.avcodec_open2(dec, codec, nullptr);
    if (ret < 0) {
        set_err(err, errlen, "avcodec_open2: " + av_errstr(ret));
        api.avcodec_free_context(&dec);
        api.avformat_close_input(&fmt);
        return -1;
    }
    int channels = out_channels > 0 ? out_channels : ctx_channels(dec);
    int rate = (int)ctx_int(dec, "ar");
    if (sample_rate_out) *sample_rate_out = rate;
    if (channels_out) *channels_out = channels;

    Swr* swr = nullptr;
    bool swr_failed = false;
    Rational tb = st_tb(st);
    double end_s = dur_s > 0 ? start_s + dur_s : -1.0;
    Packet* pkt = api.av_packet_alloc();
    Frame* frame = api.av_frame_alloc();
    long total = 0;
    bool draining = false;
    std::vector<int16_t> tmp;
    for (;;) {
        ret = api.avcodec_receive_frame(dec, frame);
        if (ret == 0) {
            int nb = field<int>(frame, L->frame_nb_samples);
            double pts = ts_to_sec(field<int64_t>(frame, L->frame_pts), tb);
            bool keep = true;
            if (!std::isnan(pts)) {
                if (pts + (double)nb / rate <= start_s) keep = false;
                if (end_s > 0 && pts >= end_s) keep = false;
            }
            if (keep && !swr && !swr_failed) {
                const ChannelLayout* in_layout =
                    &field<ChannelLayout>(frame, L->frame_ch_layout);
                ChannelLayout out_layout{};
                if (out_channels > 0)
                    api.av_channel_layout_default(&out_layout, out_channels);
                else
                    api.av_channel_layout_copy(&out_layout, in_layout);
                int sret = api.swr_alloc_set_opts2(&swr, &out_layout, SAMPLE_FMT_S16, rate,
                                                   in_layout, field<int>(frame, L->frame_format),
                                                   rate, 0, nullptr);
                api.av_channel_layout_uninit(&out_layout);
                if (sret < 0 || api.swr_init(swr) < 0) {
                    swr_failed = true;
                    api.swr_free(&swr);
                }
            }
            if (keep && swr) {
                tmp.resize((size_t)nb * channels);
                uint8_t* outp = (uint8_t*)tmp.data();
                int got = api.swr_convert(
                    swr, &outp, nb,
                    (const uint8_t**)field<uint8_t**>(frame, L->frame_extended_data), nb);
                if (got > 0) {
                    if (buf && total + got <= buf_samples)
                        memcpy(buf + (size_t)total * channels, tmp.data(), (size_t)got * channels * 2);
                    total += got;
                }
            }
            api.av_frame_unref(frame);
            if (swr_failed) break;
            continue;
        }
        if (ret == ERR_EOF) break;
        if (ret != ERR_EAGAIN) break;
        if (draining) break;
        if (api.av_read_frame(fmt, pkt) < 0) {
            draining = true;
            api.avcodec_send_packet(dec, nullptr);
            continue;
        }
        if (field<int>(pkt, L->pkt_stream_index) == sidx) api.avcodec_send_packet(dec, pkt);
        api.av_packet_unref(pkt);
    }
    api.av_packet_free(&pkt);
    api.av_frame_free(&frame);
    api.swr_free(&swr);
    api.avcodec_free_context(&dec);
    api.avformat_close_input(&fmt);
    if (swr_failed) {
        set_err(err, errlen, "swr_init failed");
        return -1;
    }
    return total;
}

// ---------------------------------------------------------------------------
// Encoding / muxing
// ---------------------------------------------------------------------------

struct MPEncoder {
    Fmt* fmt = nullptr;
    Ctx* venc = nullptr;
    Ctx* aenc = nullptr;
    Stream* vstream = nullptr;
    Stream* astream = nullptr;
    Rational vtb{0, 1}, atb{0, 1};  // codec time bases
    int width = 0, height = 0, pix_fmt = PIX_FMT_NONE;
    int sample_rate = 0, channels = 0, sample_fmt = SAMPLE_FMT_NONE, frame_size = 0;
    ChannelLayout layout{};
    Swr* swr = nullptr;  // s16 interleaved -> aenc sample_fmt
    Frame* vframe = nullptr;
    Frame* aframe = nullptr;
    int64_t vpts = 0;
    int64_t apts = 0;  // in samples
    std::vector<int16_t> abuf;  // pending audio (interleaved s16)
    int64_t last_dts[2] = {INT64_MIN, INT64_MIN};  // per-stream mux fixup
    FILE* stats_file = nullptr;  // two-pass: pass 1 statistics out
    std::string stats_out_path;  // where stats_out goes, opened lazily
    bool header_written = false;

    // Frame-parallel encode ("pc_fp_workers=N" in the option string): FFV1
    // with gop=1 makes every frame a keyframe with fresh range-coder state,
    // so N workers each encode on a private context and the caller thread
    // muxes finished packets in sequence order.
    int fp_workers = 0;
    std::vector<Ctx*> fp_ctxs;
    std::vector<std::thread> fp_threads;
    std::deque<std::pair<int64_t, Frame*>> fp_q;        // seq -> frame
    std::map<int64_t, std::vector<Packet*>> fp_done;    // seq -> packets
    int64_t fp_next_mux = 0;
    int64_t fp_inflight = 0;
    bool fp_stop = false;
    bool fp_error = false;
    std::string fp_error_msg;
    std::mutex fp_mu;
    std::condition_variable fp_cv_work;
    std::condition_variable fp_cv_done;
};

static int mux_packet(MPEncoder* e, Packet* pkt, Rational ctx_tb, Stream* st, bool video) {
    if (video && field<int64_t>(pkt, L->pkt_duration) == 0) field<int64_t>(pkt, L->pkt_duration) = 1;
    api.av_packet_rescale_ts(pkt, ctx_tb, st_tb(st));
    int idx = st_index(st);
    field<int>(pkt, L->pkt_stream_index) = idx;
    // non-monotonic DTS fixup, as the ffmpeg CLI mux layer does
    int si = idx < 2 ? idx : 1;
    int64_t& dts = field<int64_t>(pkt, L->pkt_dts);
    int64_t& pts = field<int64_t>(pkt, L->pkt_pts);
    if (dts != NOPTS && e->last_dts[si] != INT64_MIN && dts <= e->last_dts[si]) {
        dts = e->last_dts[si] + 1;
        if (pts != NOPTS && pts < dts) pts = dts;
    }
    if (dts != NOPTS) e->last_dts[si] = dts;
    return api.av_interleaved_write_frame(e->fmt, pkt);
}

// Pass 1: append the encoder's stats_out, when it has one, to the
// statistics file, which is opened on the first stats_out only (an encoder
// that keeps its statistics itself leaves no empty file behind).
static void collect_stats(MPEncoder* e) {
    if (e->stats_out_path.empty()) return;
    const char* s = field<const char*>(e->venc, g_ctx_stats_out_off);
    char first;
    if (!s || !safe_read(s, &first, 1)) return;
    if (!e->stats_file) e->stats_file = fopen(e->stats_out_path.c_str(), "w");
    if (e->stats_file) fputs(s, e->stats_file);
}

static int enc_write_packets(MPEncoder* e, Ctx* ctx, Rational ctx_tb, Stream* st) {
    Packet* pkt = api.av_packet_alloc();
    int ret;
    while ((ret = api.avcodec_receive_packet(ctx, pkt)) == 0) {
        int wret = mux_packet(e, pkt, ctx_tb, st, ctx == e->venc);
        api.av_packet_unref(pkt);
        if (wret < 0) {
            api.av_packet_free(&pkt);
            return wret;
        }
        if (ctx == e->venc) collect_stats(e);
    }
    api.av_packet_free(&pkt);
    return (ret == ERR_EAGAIN || ret == ERR_EOF) ? 0 : ret;
}

// Copy contiguous caller plane buffers into an allocated AVFrame.
static int fill_vframe(Frame* f, const uint8_t* const planes[4]) {
    int ret = api.av_frame_make_writable(f);
    if (ret < 0) return ret;
    int fmt = field<int>(f, L->frame_format);
    int w = field<int>(f, L->frame_width), h = field<int>(f, L->frame_height);
    const void* desc = api.av_pix_fmt_desc_get(fmt);
    int nplanes = api.av_pix_fmt_count_planes(fmt);
    int bps = desc_depth(desc) > 8 ? 2 : 1;
    uint8_t** data = frame_data(f);
    int* linesize = frame_linesize(f);
    for (int p = 0; p < nplanes && p < 4; p++) {
        if (!planes[p]) continue;
        int ph = (p == 1 || p == 2) ? ceil_rshift(h, desc_log2_h(desc)) : h;
        int row_bytes = plane_row_bytes(fmt, w, p, desc, bps);
        for (int y = 0; y < ph; y++)
            memcpy(data[p] + (size_t)y * linesize[p], planes[p] + (size_t)y * row_bytes,
                   (size_t)row_bytes);
    }
    return 0;
}

static Frame* new_video_frame(MPEncoder* e) {
    Frame* f = api.av_frame_alloc();
    if (!f) return nullptr;
    field<int>(f, L->frame_format) = e->pix_fmt;
    field<int>(f, L->frame_width) = e->width;
    field<int>(f, L->frame_height) = e->height;
    if (api.av_frame_get_buffer(f, 0) < 0) api.av_frame_free(&f);
    return f;
}

static void fp_worker_main(MPEncoder* e, Ctx* ctx) {
    for (;;) {
        int64_t seq;
        Frame* frame;
        {
            std::unique_lock<std::mutex> lk(e->fp_mu);
            e->fp_cv_work.wait(lk, [&] { return e->fp_stop || !e->fp_q.empty(); });
            if (e->fp_q.empty()) break;  // fp_stop and drained
            seq = e->fp_q.front().first;
            frame = e->fp_q.front().second;
            e->fp_q.pop_front();
        }
        std::vector<Packet*> pkts;
        int ret = api.avcodec_send_frame(ctx, frame);
        while (ret >= 0) {
            Packet* pkt = api.av_packet_alloc();
            ret = api.avcodec_receive_packet(ctx, pkt);
            if (ret == 0) {
                pkts.push_back(pkt);
                continue;
            }
            api.av_packet_free(&pkt);
            if (ret == ERR_EAGAIN || ret == ERR_EOF) ret = 0;
            break;
        }
        api.av_frame_free(&frame);
        {
            std::lock_guard<std::mutex> lk(e->fp_mu);
            if (ret < 0) {
                for (auto* p : pkts) api.av_packet_free(&p);
                if (!e->fp_error) {
                    e->fp_error = true;
                    e->fp_error_msg = "fp encode: " + av_errstr(ret);
                }
                e->fp_done[seq] = {};  // the seq must resolve or the mux stalls
            } else {
                e->fp_done[seq] = std::move(pkts);
            }
        }
        e->fp_cv_done.notify_all();
    }
    // stragglers carry their frame's pts (== seq)
    api.avcodec_send_frame(ctx, nullptr);
    for (;;) {
        Packet* pkt = api.av_packet_alloc();
        if (api.avcodec_receive_packet(ctx, pkt) != 0) {
            api.av_packet_free(&pkt);
            break;
        }
        std::lock_guard<std::mutex> lk(e->fp_mu);
        e->fp_done[field<int64_t>(pkt, L->pkt_pts)].push_back(pkt);
    }
    e->fp_cv_done.notify_all();
}

// Mux every finished sequence that is next in order (caller thread, fp_mu
// held via lk; dropped around the writes).
static int fp_mux_ready_locked(MPEncoder* e, std::unique_lock<std::mutex>& lk) {
    for (;;) {
        auto it = e->fp_done.begin();
        if (it == e->fp_done.end() || it->first != e->fp_next_mux) return 0;
        std::vector<Packet*> pkts = std::move(it->second);
        e->fp_done.erase(it);
        lk.unlock();
        int ret = 0;
        for (auto* pkt : pkts) {
            if (ret >= 0) ret = mux_packet(e, pkt, e->vtb, e->vstream, true);
            api.av_packet_free(&pkt);
        }
        lk.lock();
        e->fp_next_mux++;
        e->fp_inflight--;
        e->fp_cv_done.notify_all();
        if (ret < 0) {
            if (!e->fp_error) {
                e->fp_error = true;
                e->fp_error_msg = "fp mux: " + av_errstr(ret);
            }
            return ret;
        }
    }
}

static bool is_intra_only(const Codec* vc) {
    for (const char* name : {"ffv1", "prores", "prores_aw", "prores_ks"})
        if (vc == api.avcodec_find_encoder_by_name(name)) return true;
    return false;
}

// The encoder's supported sample formats, SAMPLE_FMT_NONE-terminated.
static const int* codec_sample_fmts(const Codec* c) {
    if (api.avcodec_get_supported_config) {
        const void* out = nullptr;
        int n = 0;
        if (api.avcodec_get_supported_config(nullptr, c, CODEC_CONFIG_SAMPLE_FORMAT, 0, &out,
                                             &n) < 0)
            return nullptr;
        return static_cast<const int*>(out);
    }
    return field<const int*>(c, L->codec_sample_fmts);
}

static void enc_free(MPEncoder* e) {
    for (auto*& wc : e->fp_ctxs) api.avcodec_free_context(&wc);
    e->fp_ctxs.clear();
    if (e->stats_file) fclose(e->stats_file);
    // stats_in is the caller's to free (libavcodec never frees it)
    if (e->venc && g_ctx_stats_in_off >= 0) api.av_freep(&field<char*>(e->venc, g_ctx_stats_in_off));
    if (e->fmt && e->header_written && !(ofmt_flags(e->fmt) & FMT_NOFILE))
        api.avio_closep(&field<Pb*>(e->fmt, L->fmt_pb));
    api.av_frame_free(&e->vframe);
    api.av_frame_free(&e->aframe);
    api.swr_free(&e->swr);
    api.avcodec_free_context(&e->venc);
    if (e->aenc) api.avcodec_free_context(&e->aenc);
    api.av_channel_layout_uninit(&e->layout);
    if (e->fmt) api.avformat_free_context(e->fmt);
    delete e;
}

// Configure a video encoder context from the explicit arguments, through
// its AVOptions. Returns the name of an option the context refused, or null.
static const char* set_video_opts(Ctx* c, int width, int height, int pf, Rational tb, int64_t bit_rate,
                           int64_t min_rate, int64_t max_rate, int64_t buf_size, int gop_size,
                           int bframes, int threads, int64_t flags) {
    if (api.av_opt_set_int(c, "strict", COMPLIANCE_EXPERIMENTAL, 0) < 0) return "strict";
    if (api.av_opt_set_image_size(c, "video_size", width, height, 0) < 0) return "video_size";
    if (api.av_opt_set_q(c, "time_base", tb, 0) < 0) return "time_base";
    if (api.av_opt_set_pixel_fmt(c, "pixel_format", pf, 0) < 0) return "pixel_format";
    if (bit_rate > 0) api.av_opt_set_int(c, "b", bit_rate, 0);
    if (min_rate > 0) api.av_opt_set_int(c, "minrate", min_rate, 0);
    if (max_rate > 0) api.av_opt_set_int(c, "maxrate", max_rate, 0);
    if (buf_size > 0) api.av_opt_set_int(c, "bufsize", buf_size, 0);
    if (gop_size >= 0) api.av_opt_set_int(c, "g", gop_size, 0);
    if (bframes >= 0) api.av_opt_set_int(c, "bf", bframes, 0);
    if (threads >= 0) api.av_opt_set_int(c, "threads", threads, 0);
    if (flags) api.av_opt_set_int(c, "flags", ctx_int(c, "flags") | flags, 0);
    return nullptr;
}

// Why the encoder `name` cannot exchange two-pass statistics through
// stats_out/stats_in on this libav, or "" when it can.
static std::string twopass_refusal(const char* name) {
    std::string key = std::string(" ") + name + "=";
    size_t at = (" " + g_twopass).find(key);
    if (at != std::string::npos) {
        std::string verdict = g_twopass.substr(at + key.size() - 1);
        verdict = verdict.substr(0, verdict.find(' '));
        if (verdict != "ok")
            return std::string("two-pass with ") + name +
                   " is refused on this libav: its round trip at load read " + verdict;
    }
    if (g_ctx_stats_in_off < 0)
        return std::string("two-pass with ") + name +
               " needs AVCodecContext.stats_out/stats_in, which no round trip proved on this libav";
    return "";
}

// The extradata an opened context would give its stream.
static std::string ctx_extradata(Ctx* c) {
    Par* par = api.avcodec_parameters_alloc();
    std::string out;
    if (par && api.avcodec_parameters_from_context(par, c) >= 0) {
        const uint8_t* x = field<const uint8_t*>(par, L->par_extradata);
        int n = field<int>(par, L->par_extradata_size);
        if (x && n > 0) out.assign((const char*)x, (size_t)n);
    }
    api.avcodec_parameters_free(&par);
    return out;
}

// Open an encoder+muxer. Video is configured from explicit arguments plus an
// ffmpeg-style options string "k=v:k=v" applied to the codec context
// (private options included); entries the codec does not consume reach the
// muxer. Audio is optional (acodec == nullptr or "" to disable). pass: 0 =
// single pass, 1/2 = two-pass with statistics at stats_path. vopts may carry
// "pc_fp_workers=N" (consumed here, single-pass only): frame-parallel encode
// across N private contexts, intra-only codecs (ffv1 with gop=1 forced,
// prores).
EXPORT MPEncoder* mp_encoder_open(
    const char* path, const char* vcodec, int width, int height,
    const char* pix_fmt, int fps_num, int fps_den, int64_t bit_rate,
    int64_t min_rate, int64_t max_rate, int64_t buf_size, int gop_size,
    int bframes, int threads, const char* vopts, int pass,
    const char* stats_path, const char* acodec, int sample_rate, int channels,
    int64_t audio_bit_rate, char* err, int errlen) {
    auto* e = new MPEncoder();
    int ret = api.avformat_alloc_output_context2(&e->fmt, nullptr, nullptr, path);
    if (ret < 0 || !e->fmt) {
        set_err(err, errlen, "alloc_output: " + av_errstr(ret));
        e->fmt = nullptr;
        enc_free(e);
        return nullptr;
    }
    const Codec* vc = api.avcodec_find_encoder_by_name(vcodec);
    if (!vc) {
        set_err(err, errlen, std::string("no encoder: ") + vcodec);
        enc_free(e);
        return nullptr;
    }
    int pf = api.av_get_pix_fmt(pix_fmt);
    if (pf == PIX_FMT_NONE) {
        set_err(err, errlen, std::string("bad pix_fmt: ") + pix_fmt);
        enc_free(e);
        return nullptr;
    }
    api.av_opt_set_int(e->fmt, "strict", COMPLIANCE_EXPERIMENTAL, 0);
    bool global_header = ofmt_flags(e->fmt) & FMT_GLOBALHEADER;
    e->width = width;
    e->height = height;
    e->pix_fmt = pf;
    e->vtb = Rational{fps_den, fps_num};
    e->venc = api.avcodec_alloc_context3(vc);
    Dict* opts = nullptr;
    auto fail = [&](const std::string& msg) -> MPEncoder* {
        set_err(err, errlen, msg);
        api.av_dict_free(&opts);
        enc_free(e);
        return nullptr;
    };
    int64_t pass_flag = pass == 1 ? CODEC_FLAG_PASS1 : pass == 2 ? CODEC_FLAG_PASS2 : 0;
    if (const char* bad = set_video_opts(e->venc, width, height, pf, e->vtb, bit_rate, min_rate,
                                         max_rate, buf_size, gop_size, bframes, threads,
                                         (global_header ? CODEC_FLAG_GLOBAL_HEADER : 0) | pass_flag))
        return fail(std::string("the video encoder context refused option ") + bad);
    if (pass_flag) {
        // x264 reads and writes its statistics file itself through its
        // private "stats" option (the ffmpeg CLI's -passlogfile), and
        // libx265 takes pass and stats inside x265-params. Any other
        // encoder emits stats_out in pass 1, collected into the file, and
        // reads the file back through stats_in in pass 2.
        if (api.av_opt_set(e->venc, "stats", stats_path, OPT_SEARCH_CHILDREN) != 0) {
            std::string why = twopass_refusal(vcodec);
            if (!why.empty() && strcmp(vcodec, "libx265") != 0) return fail(why);
            if (why.empty() && pass == 1) {
                e->stats_out_path = stats_path;
            } else if (why.empty()) {
                // a missing file is not an error here: libx265 may leave
                // none at stats_path, and an encoder that needs stats_in
                // fails at open without it
                if (FILE* f = fopen(stats_path, "rb")) {
                    std::string text;
                    char buf[65536];
                    size_t n;
                    while ((n = fread(buf, 1, sizeof(buf), f)) > 0) text.append(buf, n);
                    fclose(f);
                    field<char*>(e->venc, g_ctx_stats_in_off) = api.av_strdup(text.c_str());
                }
            }
        }
    }
    if (vopts && vopts[0] && api.av_dict_parse_string(&opts, vopts, "=", ":", 0) < 0)
        return fail("bad vopts string");
    if (DictEntry* fpw = api.av_dict_get(opts, "pc_fp_workers", nullptr, 0)) {
        e->fp_workers = atoi(fpw->value);
        api.av_dict_set(&opts, "pc_fp_workers", nullptr, 0);
        if (e->fp_workers > 0 && !is_intra_only(vc))
            return fail("pc_fp_workers requires an intra-only codec (ffv1/prores)");
        if (e->fp_workers > 0 && pass != 0) return fail("pc_fp_workers is single-pass only");
        if (e->fp_workers > 64) e->fp_workers = 64;
        if (e->fp_workers > 0) api.av_opt_set_int(e->venc, "g", 1, 0);
    }
    ret = api.avcodec_open2(e->venc, vc, &opts);
    if (ret < 0) return fail("video avcodec_open2: " + av_errstr(ret));
    e->vstream = api.avformat_new_stream(e->fmt, nullptr);
    field<Rational>(e->vstream, L->st_time_base) = e->vtb;
    api.avcodec_parameters_from_context(st_par(e->vstream), e->venc);

    if (e->fp_workers > 0) {
        // one private context per worker, configured identically to venc;
        // its extradata must equal venc's, which the muxer carries
        std::string ref = ctx_extradata(e->venc);
        for (int wi = 0; wi < e->fp_workers; wi++) {
            Ctx* c = api.avcodec_alloc_context3(vc);
            (void)set_video_opts(c, width, height, pf, e->vtb, ctx_int(e->venc, "b"),
                           ctx_int(e->venc, "minrate"), ctx_int(e->venc, "maxrate"),
                           ctx_int(e->venc, "bufsize"), 1, 0, threads >= 0 ? threads : 1,
                           global_header ? CODEC_FLAG_GLOBAL_HEADER : 0);
            Dict* wopts = nullptr;
            if (vopts && vopts[0]) {
                api.av_dict_parse_string(&wopts, vopts, "=", ":", 0);
                api.av_dict_set(&wopts, "pc_fp_workers", nullptr, 0);
            }
            ret = api.avcodec_open2(c, vc, &wopts);
            api.av_dict_free(&wopts);
            if (ret < 0 || ctx_extradata(c) != ref) {
                api.avcodec_free_context(&c);
                return fail(ret < 0 ? "fp worker avcodec_open2: " + av_errstr(ret)
                                    : std::string("fp worker extradata mismatch"));
            }
            e->fp_ctxs.push_back(c);
        }
    }

    if (acodec && acodec[0]) {
        const Codec* ac = api.avcodec_find_encoder_by_name(acodec);
        if (!ac) return fail(std::string("no audio encoder: ") + acodec);
        e->aenc = api.avcodec_alloc_context3(ac);
        // prefer s16 when the codec supports it (flac/pcm), else its first
        const int* fmts = codec_sample_fmts(ac);
        int sf = fmts && fmts[0] != SAMPLE_FMT_NONE ? fmts[0] : SAMPLE_FMT_S16;
        for (int i = 0; fmts && fmts[i] != SAMPLE_FMT_NONE; i++)
            if (fmts[i] == SAMPLE_FMT_S16) sf = SAMPLE_FMT_S16;
        e->sample_rate = sample_rate;
        e->channels = channels;
        e->sample_fmt = sf;
        api.av_channel_layout_default(&e->layout, channels);
        // the context's sample_fmt has no AVOption: it travels in codec
        // parameters, which avcodec_parameters_to_context applies
        Par* par = api.avcodec_parameters_alloc();
        api.avcodec_parameters_from_context(par, e->aenc);
        field<int>(par, L->par_format) = sf;
        field<int>(par, L->par_sample_rate) = sample_rate;
        api.av_channel_layout_copy(&field<ChannelLayout>(par, L->par_ch_layout), &e->layout);
        if (audio_bit_rate > 0) field<int64_t>(par, L->par_bit_rate) = audio_bit_rate;
        ret = api.avcodec_parameters_to_context(e->aenc, par);
        api.avcodec_parameters_free(&par);
        if (ret < 0) return fail("audio parameters: " + av_errstr(ret));
        e->atb = Rational{1, sample_rate};
        api.av_opt_set_q(e->aenc, "time_base", e->atb, 0);
        if (global_header)
            api.av_opt_set_int(e->aenc, "flags",
                               ctx_int(e->aenc, "flags") | CODEC_FLAG_GLOBAL_HEADER, 0);
        if ((ret = api.avcodec_open2(e->aenc, ac, nullptr)) < 0)
            return fail("audio avcodec_open2: " + av_errstr(ret));
        e->frame_size = (int)ctx_int(e->aenc, "frame_size");
        e->astream = api.avformat_new_stream(e->fmt, nullptr);
        field<Rational>(e->astream, L->st_time_base) = e->atb;
        api.avcodec_parameters_from_context(st_par(e->astream), e->aenc);
        if (sf != SAMPLE_FMT_S16) {
            ret = api.swr_alloc_set_opts2(&e->swr, &e->layout, sf, sample_rate, &e->layout,
                                          SAMPLE_FMT_S16, sample_rate, 0, nullptr);
            if (ret < 0 || api.swr_init(e->swr) < 0) return fail("audio swr_init failed");
        }
        e->aframe = api.av_frame_alloc();
    }

    if (!(ofmt_flags(e->fmt) & FMT_NOFILE)) {
        ret = api.avio_open(&field<Pb*>(e->fmt, L->fmt_pb), path, IO_FLAG_WRITE);
        if (ret < 0) return fail("avio_open: " + av_errstr(ret));
    }
    const char* oname = field<const char*>(field<const void*>(e->fmt, L->fmt_oformat), L->ofmt_name);
    if (oname && strstr(oname, "mp4") && !api.av_dict_get(opts, "video_track_timescale", nullptr, 0))
        api.av_dict_set(&opts, "video_track_timescale", "90000", 0);
    ret = api.avformat_write_header(e->fmt, &opts);
    if (ret < 0) {
        if (!(ofmt_flags(e->fmt) & FMT_NOFILE)) api.avio_closep(&field<Pb*>(e->fmt, L->fmt_pb));
        return fail("write_header: " + av_errstr(ret));
    }
    api.av_dict_free(&opts);
    e->header_written = true;
    e->vframe = new_video_frame(e);
    if (!e->vframe) return fail("video frame alloc failed");
    for (auto* c : e->fp_ctxs) e->fp_threads.emplace_back(fp_worker_main, e, c);
    return e;
}

static int write_video_frame(MPEncoder* e, const uint8_t* planes[4], char* err, int errlen) {
    int ret;
    if (e->fp_workers > 0) {
        // Any error here also latches fp_error, so a caller that keeps
        // writing fails fast instead of waiting on a seq never enqueued.
        auto fp_fail = [&](const std::string& msg) {
            set_err(err, errlen, msg);
            std::lock_guard<std::mutex> flk(e->fp_mu);
            if (!e->fp_error) {
                e->fp_error = true;
                e->fp_error_msg = msg;
            }
            e->fp_cv_done.notify_all();
            return -1;
        };
        Frame* f = new_video_frame(e);
        if (!f) return fp_fail("fp frame alloc failed");
        if ((ret = fill_vframe(f, planes)) < 0) {
            api.av_frame_free(&f);
            return fp_fail("fp frame fill: " + av_errstr(ret));
        }
        int64_t seq = e->vpts++;
        field<int64_t>(f, L->frame_pts) = seq;
        std::unique_lock<std::mutex> lk(e->fp_mu);
        // backpressure: 2 frames per worker + 2 in flight
        while (!e->fp_error && e->fp_inflight >= 2 * (int64_t)e->fp_workers + 2) {
            if (fp_mux_ready_locked(e, lk) < 0) break;
            if (e->fp_inflight >= 2 * (int64_t)e->fp_workers + 2 && !e->fp_error)
                e->fp_cv_done.wait(lk);
        }
        if (e->fp_error) {
            api.av_frame_free(&f);
            set_err(err, errlen, e->fp_error_msg);
            return -1;
        }
        e->fp_q.emplace_back(seq, f);
        e->fp_inflight++;
        lk.unlock();
        e->fp_cv_work.notify_one();
        lk.lock();
        if (fp_mux_ready_locked(e, lk) < 0 || e->fp_error) {
            set_err(err, errlen, e->fp_error_msg);
            return -1;
        }
        return 0;
    }
    if ((ret = fill_vframe(e->vframe, planes)) < 0) {
        set_err(err, errlen, "frame not writable");
        return -1;
    }
    field<int64_t>(e->vframe, L->frame_pts) = e->vpts++;
    ret = api.avcodec_send_frame(e->venc, e->vframe);
    if (ret < 0) {
        set_err(err, errlen, "send_frame: " + av_errstr(ret));
        return -1;
    }
    ret = enc_write_packets(e, e->venc, e->vtb, e->vstream);
    if (ret < 0) {
        set_err(err, errlen, "write packets: " + av_errstr(ret));
        return -1;
    }
    return 0;
}

EXPORT int mp_encoder_write_video(MPEncoder* e, const uint8_t* p0, const uint8_t* p1,
                                  const uint8_t* p2, const uint8_t* p3, char* err,
                                  int errlen) {
    const uint8_t* planes[4] = {p0, p1, p2, p3};
    return write_video_frame(e, planes, err, errlen);
}

// `n` frames from contiguous [N, plane_h, plane_w] plane blocks in ONE call.
EXPORT long mp_encoder_write_video_batch(MPEncoder* e, const uint8_t* p0, const uint8_t* p1,
                                         const uint8_t* p2, const uint8_t* p3, long n,
                                         char* err, int errlen) {
    const uint8_t* bases[4] = {p0, p1, p2, p3};
    const void* desc = api.av_pix_fmt_desc_get(e->pix_fmt);
    if (!desc) {
        set_err(err, errlen, "batch encode: unknown encoder pix_fmt");
        return -1;
    }
    int nplanes = api.av_pix_fmt_count_planes(e->pix_fmt);
    int bps = desc_depth(desc) > 8 ? 2 : 1;
    size_t fsize[4] = {0, 0, 0, 0};
    for (int p = 0; p < nplanes && p < 4; p++) {
        int ph = (p == 1 || p == 2) ? ceil_rshift(e->height, desc_log2_h(desc)) : e->height;
        fsize[p] = (size_t)ph * (size_t)plane_row_bytes(e->pix_fmt, e->width, p, desc, bps);
    }
    for (long i = 0; i < n; i++) {
        const uint8_t* planes[4];
        for (int p = 0; p < 4; p++) planes[p] = bases[p] ? bases[p] + (size_t)i * fsize[p] : nullptr;
        if (write_video_frame(e, planes, err, errlen) < 0) return -1;
    }
    return n;
}

// Encode `count` samples (per channel) from the front of abuf.
static int encode_audio_frame(MPEncoder* e, int count) {
    Frame* f = e->aframe;
    field<int>(f, L->frame_nb_samples) = count;
    field<int>(f, L->frame_format) = e->sample_fmt;
    field<int>(f, L->frame_sample_rate) = e->sample_rate;
    api.av_channel_layout_copy(&field<ChannelLayout>(f, L->frame_ch_layout), &e->layout);
    int ret = api.av_frame_get_buffer(f, 0);
    if (ret < 0) return ret;
    uint8_t** data = frame_data(f);
    if (e->swr) {
        const uint8_t* in = (const uint8_t*)e->abuf.data();
        api.swr_convert(e->swr, field<uint8_t**>(f, L->frame_extended_data), count, &in, count);
    } else {
        memcpy(data[0], e->abuf.data(), (size_t)count * e->channels * 2);
    }
    field<int64_t>(f, L->frame_pts) = e->apts;
    e->apts += count;
    ret = api.avcodec_send_frame(e->aenc, f);
    api.av_frame_unref(f);
    return ret;
}

// Append interleaved s16 audio samples (n per channel).
EXPORT int mp_encoder_write_audio(MPEncoder* e, const int16_t* samples, long n, char* err,
                                  int errlen) {
    if (!e->aenc) {
        set_err(err, errlen, "no audio stream configured");
        return -1;
    }
    int channels = e->channels;
    e->abuf.insert(e->abuf.end(), samples, samples + (size_t)n * channels);
    int frame_size = e->frame_size > 0 ? e->frame_size : 4096;
    while ((long)(e->abuf.size() / channels) >= frame_size) {
        int ret = encode_audio_frame(e, frame_size);
        if (ret < 0) {
            set_err(err, errlen, "audio send_frame: " + av_errstr(ret));
            return -1;
        }
        ret = enc_write_packets(e, e->aenc, e->atb, e->astream);
        if (ret < 0) {
            set_err(err, errlen, "audio write packets: " + av_errstr(ret));
            return -1;
        }
        e->abuf.erase(e->abuf.begin(), e->abuf.begin() + (size_t)frame_size * channels);
    }
    return 0;
}

EXPORT int mp_encoder_close(MPEncoder* e, char* err, int errlen) {
    int rc = 0;
    if (!e) return 0;
    if (!e->fp_threads.empty()) {
        // stop the pool: workers drain the queue and flush; then mux the
        // rest in order on this thread
        {
            std::lock_guard<std::mutex> lk(e->fp_mu);
            e->fp_stop = true;
        }
        e->fp_cv_work.notify_all();
        for (auto& t : e->fp_threads) t.join();
        e->fp_threads.clear();
        std::unique_lock<std::mutex> lk(e->fp_mu);
        if (fp_mux_ready_locked(e, lk) < 0) rc = -1;
        // anything still parked is unreachable (a gap): never written
        for (auto& kv : e->fp_done)
            for (auto* p : kv.second) api.av_packet_free(&p);
        e->fp_done.clear();
        if (e->fp_error) rc = -1;
    }
    if (e->header_written) {
        api.avcodec_send_frame(e->venc, nullptr);
        if (enc_write_packets(e, e->venc, e->vtb, e->vstream) < 0) rc = -1;
        if (e->aenc) {
            long rem = (long)(e->abuf.size() / e->channels);
            if (rem > 0 && encode_audio_frame(e, (int)rem) < 0) rc = -1;
            api.avcodec_send_frame(e->aenc, nullptr);
            if (enc_write_packets(e, e->aenc, e->atb, e->astream) < 0) rc = -1;
        }
        // libvpx and libaom set stats_out when the flush ends pass 1
        collect_stats(e);
        if (api.av_write_trailer(e->fmt) < 0) rc = -1;
    }
    std::string msg = e->fp_error_msg;
    enc_free(e);
    if (rc < 0) set_err(err, errlen, msg.empty() ? "failures while flushing encoder" : msg);
    return rc;
}

// ---------------------------------------------------------------------------
// Bitstream extraction for exact frame sizes (io/framesizes.py parses the
// bytes)
// ---------------------------------------------------------------------------

// Open `path` and find its video stream: its index, or -1 with err set.
static int open_video(Fmt** fmt, const char* path, char* err, int errlen) {
    if (open_input(fmt, path, err, errlen) < 0) return -1;
    int sidx = api.av_find_best_stream(*fmt, MEDIA_VIDEO, -1, -1, nullptr, 0);
    if (sidx < 0) {
        set_err(err, errlen, "no video stream");
        api.avformat_close_input(fmt);
    }
    return sidx;
}

// Run the named bitstream filter (h264_mp4toannexb / hevc_mp4toannexb) over
// the video stream and write the filtered bytes to out_path.
EXPORT int mp_extract_annexb(const char* path, const char* bsf_name, const char* out_path,
                             char* err, int errlen) {
    const void* filter = api.av_bsf_get_by_name(bsf_name);
    if (!filter) {
        set_err(err, errlen, std::string("this libav has no bitstream filter ") + bsf_name);
        return -1;
    }
    Fmt* fmt = nullptr;
    int sidx = open_video(&fmt, path, err, errlen);
    if (sidx < 0) return -1;
    Stream* st = fmt_stream(fmt, (unsigned)sidx);
    Bsf* b = nullptr;
    int ret = api.av_bsf_alloc(filter, &b);
    if (ret >= 0) {
        api.avcodec_parameters_copy(field<Par*>(b, L->bsf_par_in), st_par(st));
        field<Rational>(b, L->bsf_time_base_in) = st_tb(st);
        ret = api.av_bsf_init(b);
    }
    if (ret < 0) {
        set_err(err, errlen, "bsf_init: " + av_errstr(ret));
        api.av_bsf_free(&b);
        api.avformat_close_input(&fmt);
        return -1;
    }
    FILE* out = fopen(out_path, "wb");
    if (!out) {
        set_err(err, errlen, "cannot open output");
        api.av_bsf_free(&b);
        api.avformat_close_input(&fmt);
        return -1;
    }
    Packet* pkt = api.av_packet_alloc();
    Packet* fpkt = api.av_packet_alloc();
    auto drain = [&]() {
        while (api.av_bsf_receive_packet(b, fpkt) == 0) {
            fwrite(field<uint8_t*>(fpkt, L->pkt_data), 1, (size_t)field<int>(fpkt, L->pkt_size), out);
            api.av_packet_unref(fpkt);
        }
    };
    while (api.av_read_frame(fmt, pkt) >= 0) {
        // send_packet takes the packet's reference on success
        if (field<int>(pkt, L->pkt_stream_index) == sidx && api.av_bsf_send_packet(b, pkt) == 0)
            drain();
        api.av_packet_unref(pkt);
    }
    api.av_bsf_send_packet(b, nullptr);
    drain();
    api.av_packet_free(&fpkt);
    api.av_packet_free(&pkt);
    fclose(out);
    api.av_bsf_free(&b);
    api.avformat_close_input(&fmt);
    return 0;
}

// Write the video stream as an IVF file (VP9 exact frame sizes).
EXPORT int mp_extract_ivf(const char* path, const char* out_path, char* err, int errlen) {
    Fmt* fmt = nullptr;
    int sidx = open_video(&fmt, path, err, errlen);
    if (sidx < 0) return -1;
    Stream* st = fmt_stream(fmt, (unsigned)sidx);
    Par* par = st_par(st);
    FILE* out = fopen(out_path, "wb");
    if (!out) {
        set_err(err, errlen, "cannot open output");
        api.avformat_close_input(&fmt);
        return -1;
    }
    uint8_t hdr[32] = {0};
    memcpy(hdr, "DKIF", 4);
    hdr[6] = 32;  // header size; version 0
    const char* cname = api.avcodec_get_name(field<int>(par, L->par_codec_id));
    const char* fourcc = cname && !strcmp(cname, "vp9") ? "VP90"
                         : cname && !strcmp(cname, "vp8") ? "VP80"
                                                          : "AV01";
    memcpy(hdr + 8, fourcc, 4);
    int w = field<int>(par, L->par_width), h = field<int>(par, L->par_height);
    hdr[12] = w & 0xff; hdr[13] = (w >> 8) & 0xff;
    hdr[14] = h & 0xff; hdr[15] = (h >> 8) & 0xff;
    Rational tb = st_tb(st);
    uint32_t tb_den = (uint32_t)tb.den, tb_num = (uint32_t)tb.num;
    memcpy(hdr + 16, &tb_den, 4);
    memcpy(hdr + 20, &tb_num, 4);
    fwrite(hdr, 1, 32, out);
    Packet* pkt = api.av_packet_alloc();
    uint32_t nframes = 0;
    while (api.av_read_frame(fmt, pkt) >= 0) {
        if (field<int>(pkt, L->pkt_stream_index) == sidx) {
            uint8_t fh[12];
            uint32_t sz = (uint32_t)field<int>(pkt, L->pkt_size);
            int64_t p = field<int64_t>(pkt, L->pkt_pts);
            uint64_t pts = p != NOPTS ? (uint64_t)p : nframes;
            memcpy(fh, &sz, 4);
            memcpy(fh + 4, &pts, 8);
            fwrite(fh, 1, 12, out);
            fwrite(field<uint8_t*>(pkt, L->pkt_data), 1, sz, out);
            nframes++;
        }
        api.av_packet_unref(pkt);
    }
    api.av_packet_free(&pkt);
    fseek(out, 24, SEEK_SET);  // the frame count
    fwrite(&nframes, 4, 1, out);
    fclose(out);
    api.avformat_close_input(&fmt);
    return 0;
}

// ---------------------------------------------------------------------------
// The layout check
// ---------------------------------------------------------------------------

namespace {

struct Check {
    std::string* report;
    std::string failed;
    int passed = 0;
    bool ok(bool cond, const char* name, const std::string& detail = "") {
        if (cond) {
            passed++;
            std::string entry = std::string(name) + "@" + std::to_string(mp_layout(name)) + " ";
            if (report->find(entry) == std::string::npos) *report += entry;
        } else if (failed.empty()) {
            failed = std::string(name) + " (offset " + std::to_string(mp_layout(name)) +
                     ") failed its round trip" + (detail.empty() ? "" : ": " + detail);
        }
        return cond;
    }
};

bool check_structs(Check& c, const std::string& dir) {
    // AVPixFmtDescriptor: depth and chroma shifts of known formats
    struct PF { const char* name; int depth; };
    for (PF pf : {PF{"yuv420p", 8}, PF{"yuv422p10le", 10}, PF{"yuv444p12le", 12}, PF{"gray16le", 16}}) {
        int id = api.av_get_pix_fmt(pf.name);
        const void* d = api.av_pix_fmt_desc_get(id);
        int sw = -1, sh = -1;
        api.av_pix_fmt_get_chroma_sub_sample(id, &sw, &sh);
        uint8_t lw = 0, lh = 0;
        int depth = 0;
        bool read = d && safe_field(d, L->desc_log2_chroma_w, &lw) &&
                    safe_field(d, L->desc_log2_chroma_h, &lh) &&
                    safe_field(d, L->desc_comp0_depth, &depth);
        if (!c.ok(read && lw == sw, "AVPixFmtDescriptor.log2_chroma_w", pf.name) ||
            !c.ok(read && lh == sh, "AVPixFmtDescriptor.log2_chroma_h", pf.name) ||
            !c.ok(read && depth == pf.depth, "AVPixFmtDescriptor.comp0_depth", pf.name))
            return false;
    }

    // AVFrame, video: av_frame_get_buffer succeeds only on the fields it
    // reads, and fills data/linesize/extended_data
    Frame* f = api.av_frame_alloc();
    int y422 = api.av_get_pix_fmt("yuv422p");
    field<int>(f, L->frame_width) = 64;
    field<int>(f, L->frame_height) = 32;
    field<int>(f, L->frame_format) = y422;
    int64_t pts = 0, be = 0;
    bool fresh = safe_field(f, L->frame_pts, &pts) && safe_field(f, L->frame_best_effort_timestamp, &be);
    bool got = api.av_frame_get_buffer(f, 0) == 0;  // frame leaked on failure: its fields are suspect
    if (!c.ok(got, "AVFrame.width") || !c.ok(got, "AVFrame.height") || !c.ok(got, "AVFrame.format"))
        return false;
    uint8_t** data = frame_data(f);
    int* ls = frame_linesize(f);
    if (!c.ok(data[0] && data[1] && data[2] && !data[3], "AVFrame.data") ||
        !c.ok(ls[0] >= 64 && ls[1] >= 32 && ls[2] >= 32 && ls[3] == 0, "AVFrame.linesize") ||
        !c.ok(field<uint8_t**>(f, L->frame_extended_data) == data, "AVFrame.extended_data") ||
        !c.ok(fresh && pts == NOPTS, "AVFrame.pts", "a new frame's pts is not AV_NOPTS_VALUE") ||
        !c.ok(fresh && be == NOPTS, "AVFrame.best_effort_timestamp",
              "a new frame's best_effort_timestamp is not AV_NOPTS_VALUE"))
        return false;
    api.av_frame_free(&f);

    // AVFrame, audio: 1000 stereo s16 samples need the layout to be read
    Frame* a = api.av_frame_alloc();
    field<int>(a, L->frame_nb_samples) = 1000;
    field<int>(a, L->frame_format) = SAMPLE_FMT_S16;
    field<int>(a, L->frame_sample_rate) = 44100;
    api.av_channel_layout_default(&field<ChannelLayout>(a, L->frame_ch_layout), 2);
    got = api.av_frame_get_buffer(a, 0) == 0;
    if (!c.ok(got && frame_linesize(a)[0] >= 4000 && frame_data(a)[0] && !frame_data(a)[1],
              "AVFrame.ch_layout") ||
        !c.ok(got, "AVFrame.nb_samples"))
        return false;
    api.av_frame_free(&a);

    // AVPacket: av_new_packet sets data/size; rescaling moves pts/dts/duration
    Packet* p = api.av_packet_alloc();
    got = api.av_new_packet(p, 100) == 0;
    if (!c.ok(got && field<int>(p, L->pkt_size) == 100, "AVPacket.size") ||
        !c.ok(field<uint8_t*>(p, L->pkt_data) != nullptr, "AVPacket.data"))
        return false;
    field<int64_t>(p, L->pkt_pts) = 10;
    field<int64_t>(p, L->pkt_dts) = 8;
    field<int64_t>(p, L->pkt_duration) = 2;
    api.av_packet_rescale_ts(p, Rational{1, 10}, Rational{1, 100});
    if (!c.ok(field<int64_t>(p, L->pkt_pts) == 100, "AVPacket.pts") ||
        !c.ok(field<int64_t>(p, L->pkt_dts) == 80, "AVPacket.dts") ||
        !c.ok(field<int64_t>(p, L->pkt_duration) == 20, "AVPacket.duration"))
        return false;
    api.av_packet_free(&p);

    // AVOutputFormat: matroska needs global headers, rawvideo has no timestamps
    const void* mkv = api.av_guess_format("matroska", nullptr, nullptr);
    const void* raw = api.av_guess_format("rawvideo", nullptr, nullptr);
    int mflags = 0, rflags = 0;
    const char* mname = nullptr;
    char nbuf[9] = {0};
    bool fl = mkv && raw && safe_field(mkv, L->ofmt_flags, &mflags) &&
              safe_field(raw, L->ofmt_flags, &rflags);
    if (!c.ok(fl && (mflags & FMT_GLOBALHEADER) && !(mflags & FMT_NOTIMESTAMPS) &&
                  (rflags & FMT_NOTIMESTAMPS),
              "AVOutputFormat.flags") ||
        !c.ok(safe_field(mkv, L->ofmt_name, &mname) && safe_read(mname, nbuf, 8) &&
                  strcmp(nbuf, "matroska") == 0,
              "AVOutputFormat.name"))
        return false;

    // AVFormatContext/AVStream: a muxer with two new streams
    Fmt* fc = nullptr;
    std::string path = dir + "/layout_probe.mkv";
    if (api.avformat_alloc_output_context2(&fc, mkv, nullptr, path.c_str()) < 0 || !fc) {
        c.failed = "avformat_alloc_output_context2 failed";
        return false;
    }
    const void* of = nullptr;
    if (!c.ok(safe_field(fc, L->fmt_oformat, &of) && of == mkv, "AVFormatContext.oformat"))
        return false;
    unsigned nbs = 99;
    bool n0 = safe_field(fc, L->fmt_nb_streams, &nbs) && nbs == 0;
    Stream* s0 = api.avformat_new_stream(fc, nullptr);
    Stream* s1 = api.avformat_new_stream(fc, nullptr);
    if (!c.ok(n0 && safe_field(fc, L->fmt_nb_streams, &nbs) && nbs == 2, "AVFormatContext.nb_streams"))
        return false;
    Stream** arr = nullptr;
    Stream* got_s[2] = {nullptr, nullptr};
    if (!c.ok(safe_field(fc, L->fmt_streams, &arr) && safe_read(arr, got_s, sizeof(got_s)) &&
                  got_s[0] == s0 && got_s[1] == s1,
              "AVFormatContext.streams"))
        return false;
    int i0 = -1, i1 = -1;
    if (!c.ok(safe_field(s0, L->st_index, &i0) && safe_field(s1, L->st_index, &i1) && i0 == 0 &&
                  i1 == 1,
              "AVStream.index"))
        return false;
    Par* p0 = nullptr;
    Par* p1 = nullptr;
    int t0 = 0, fmt0 = 0;
    // a fresh AVCodecParameters has codec_type AVMEDIA_TYPE_UNKNOWN and format -1
    if (!c.ok(safe_field(s0, L->st_codecpar, &p0) && safe_field(s1, L->st_codecpar, &p1) &&
                  safe_field(p0, L->par_codec_type, &t0) && safe_field(p0, L->par_format, &fmt0) &&
                  t0 == -1 && fmt0 == -1,
              "AVStream.codecpar"))
        return false;

    // AVCodecParameters: copied from contexts configured through options
    const Codec* ffv1 = api.avcodec_find_encoder_by_name("ffv1");
    const Codec* flac = api.avcodec_find_encoder_by_name("flac");
    if (!ffv1 || !flac) {
        c.failed = "this libav has no ffv1 or no flac encoder";
        return false;
    }
    Ctx* vctx = api.avcodec_alloc_context3(ffv1);
    api.av_opt_set_image_size(vctx, "video_size", 48, 16, 0);
    api.av_opt_set_pixel_fmt(vctx, "pixel_format", y422, 0);
    api.av_opt_set_int(vctx, "b", 1234567, 0);
    api.av_opt_set_int(vctx, "profile", 3, 0);
    api.avcodec_parameters_from_context(p0, vctx);
    api.avcodec_free_context(&vctx);
    const char* cname = api.avcodec_get_name(field<int>(p0, L->par_codec_id));
    if (!c.ok(field<int>(p0, L->par_codec_type) == MEDIA_VIDEO, "AVCodecParameters.codec_type") ||
        !c.ok(cname && strcmp(cname, "ffv1") == 0, "AVCodecParameters.codec_id") ||
        !c.ok(field<int>(p0, L->par_width) == 48, "AVCodecParameters.width") ||
        !c.ok(field<int>(p0, L->par_height) == 16, "AVCodecParameters.height") ||
        !c.ok(field<int>(p0, L->par_format) == y422, "AVCodecParameters.format") ||
        !c.ok(field<int64_t>(p0, L->par_bit_rate) == 1234567, "AVCodecParameters.bit_rate") ||
        !c.ok(field<int>(p0, L->par_profile) == 3, "AVCodecParameters.profile"))
        return false;
    Ctx* actx = api.avcodec_alloc_context3(flac);
    api.av_opt_set_int(actx, "ar", 44100, 0);
    ChannelLayout stereo{};
    api.av_channel_layout_default(&stereo, 2);
    api.av_opt_set_chlayout(actx, "ch_layout", &stereo, 0);
    api.avcodec_parameters_from_context(p1, actx);
    if (!c.ok(field<int>(p1, L->par_sample_rate) == 44100, "AVCodecParameters.sample_rate") ||
        !c.ok(field<ChannelLayout>(p1, L->par_ch_layout).nb_channels == 2 &&
                  field<ChannelLayout>(p1, L->par_ch_layout).mask == stereo.mask,
              "AVCodecParameters.ch_layout"))
        return false;
    // the format written into the parameters reaches the context, which
    // then opens as an s16 FLAC encoder whose extradata is STREAMINFO
    field<int>(p1, L->par_format) = SAMPLE_FMT_S16;
    api.avcodec_parameters_to_context(actx, p1);
    int oret = api.avcodec_open2(actx, flac, nullptr);
    api.avcodec_parameters_from_context(p1, actx);
    int xs = field<int>(p1, L->par_extradata_size);
    uint8_t info[4] = {0, 0, 0, 0};
    int64_t fsz = ctx_int(actx, "frame_size");
    bool xok = oret == 0 && xs == 34 && safe_read(field<uint8_t*>(p1, L->par_extradata), info, 4) &&
               ((info[0] << 8) | info[1]) == fsz && ((info[2] << 8) | info[3]) == fsz;
    api.avcodec_free_context(&actx);
    if (!c.ok(oret == 0, "AVCodecParameters.format", "s16 did not reach the FLAC encoder") ||
        !c.ok(xs == 34, "AVCodecParameters.extradata_size") ||
        !c.ok(xok, "AVCodecParameters.extradata"))
        return false;
    api.avformat_free_context(fc);

    // AVCodecContext coded dims: a decoder opened at 64x32 codes 64x32
    const Codec* vdec = api.avcodec_find_decoder_by_name("ffv1");
    Ctx* dctx = api.avcodec_alloc_context3(vdec);
    api.av_opt_set_image_size(dctx, "video_size", 64, 32, 0);
    api.av_opt_set_pixel_fmt(dctx, "pixel_format", y422, 0);
    bool dopen = api.avcodec_open2(dctx, vdec, nullptr) == 0;
    int cw = 0, ch = 0;
    bool cok = dopen && safe_field(dctx, g_ctx_coded_off, &cw) &&
               safe_field(dctx, g_ctx_coded_off + 4, &ch) && cw == 64 && ch == 32;
    api.avcodec_free_context(&dctx);
    if (!cok) {
        c.failed = "AVCodecContext.coded_width (\"video_size\" offset + 8) failed its round trip";
        return false;
    }
    *c.report += "AVCodecContext.coded_width@" + std::to_string(g_ctx_coded_off) + " ";

    // AVCodec.sample_fmts where it is read (no avcodec_get_supported_config)
    if (!api.avcodec_get_supported_config) {
        const int* fmts = nullptr;
        int first = -9, second = -9;
        bool sok = safe_field(flac, L->codec_sample_fmts, &fmts) && safe_read(fmts, &first, 4) &&
                   safe_read(fmts + 1, &second, 4) && first == SAMPLE_FMT_S16 &&
                   second == 2 /* s32 */;
        if (!c.ok(sok, "AVCodec.sample_fmts")) return false;
    }
    return true;
}

}  // namespace

// A small FFV1+FLAC AVI written and read back through the entry points.
static bool check_file(Check& c, const std::string& dir) {
    const int W = 48, H = 16, N = 5, RATE = 44100, NS = 8820;
    std::string path = dir + "/layout_probe.avi";
    std::vector<uint8_t> y(N * W * H), u(N * W / 2 * H), v(N * W / 2 * H);
    for (size_t i = 0; i < y.size(); i++) y[i] = (uint8_t)(i * 7 + 3);
    for (size_t i = 0; i < u.size(); i++) u[i] = (uint8_t)(i * 5 + 1);
    for (size_t i = 0; i < v.size(); i++) v[i] = (uint8_t)(i * 3 + 2);
    std::vector<int16_t> pcm(NS * 2);
    for (size_t i = 0; i < pcm.size(); i++) pcm[i] = (int16_t)((i * 37) % 20000 - 10000);
    char err[512] = {0};
    MPEncoder* e = mp_encoder_open(path.c_str(), "ffv1", W, H, "yuv422p", 25, 1, 0, 0, 0, 0, -1,
                                   -1, 1, "level=3:slicecrc=1", 0, "", "flac", RATE, 2, 0, err,
                                   sizeof(err));
    if (!e) {
        c.failed = std::string("writing the probe file: ") + err;
        return false;
    }
    bool wok = mp_encoder_write_audio(e, pcm.data(), NS, err, sizeof(err)) == 0 &&
               mp_encoder_write_video_batch(e, y.data(), u.data(), v.data(), nullptr, N, err,
                                            sizeof(err)) == N;
    if (mp_encoder_close(e, err, sizeof(err)) < 0 || !wok) {
        c.failed = std::string("writing the probe file: ") + err;
        return false;
    }
    MPFormatInfo fi;
    MPStreamInfo si[4];
    int n = mp_probe(path.c_str(), &fi, si, 4, 1, err, sizeof(err));
    if (n != 2) {
        c.failed = std::string("probing the probe file: ") + err;
        return false;
    }
    MPStreamInfo& sv = si[0];
    MPStreamInfo& sa = si[1];
    if (!c.ok(strncmp(fi.format_name, "avi", 3) == 0, "AVInputFormat.name", fi.format_name) ||
        !c.ok(strncmp(fi.format_name, "avi", 3) == 0, "AVFormatContext.iformat") ||
        !c.ok(fi.file_size > 0, "AVFormatContext.pb") ||
        // the container lasts as long as its longer stream: FLAC's last
        // block pads the audio past the video's 0.2 s
        !c.ok(fi.duration >= 0.2 && std::fabs(fi.duration - sa.duration) < 1e-6,
              "AVFormatContext.duration", std::to_string(fi.duration)) ||
        !c.ok(std::fabs((double)fi.bit_rate - fi.file_size * 8.0 / fi.duration) < 1.0,
              "AVFormatContext.bit_rate", std::to_string(fi.bit_rate)) ||
        !c.ok(sv.tb_num == 1 && sv.tb_den == 25, "AVStream.time_base") ||
        !c.ok(sv.fps_num == 25 && sv.fps_den == 1, "AVStream.r_frame_rate") ||
        !c.ok(sv.avg_fps_num == 25 && sv.avg_fps_den == 1, "AVStream.avg_frame_rate") ||
        !c.ok(std::fabs(sv.duration - 0.2) < 1e-9, "AVStream.duration") ||
        !c.ok(sv.nb_frames == N, "AVStream.nb_frames") ||
        !c.ok(sv.codec_type == 0 && sa.codec_type == 1 && sa.channels == 2 && sa.sample_rate == RATE &&
                  strcmp(sa.sample_fmt, "s16") == 0,
              "AVCodecParameters.format"))
        return false;

    // packets: five video packets 40 ms apart, key audio packets
    long nv = 0, na = 0;
    std::vector<int64_t> vs(64), as(64);
    std::vector<double> vp(64), vd(64), vu(64), ap(64), ad(64), au(64);
    std::vector<int8_t> vk(64), ak(64);
    if (mp_scan_packets_all(path.c_str(), vs.data(), vp.data(), vd.data(), vu.data(), vk.data(), 64,
                            &nv, as.data(), ap.data(), ad.data(), au.data(), ak.data(), 64, &na,
                            err, sizeof(err)) < 0) {
        c.failed = std::string("scanning the probe file: ") + err;
        return false;
    }
    bool pts_ok = nv == N, key_ok = nv == N && na > 0, size_ok = nv == N;
    for (long i = 0; i < nv && i < N; i++) {
        pts_ok = pts_ok && std::fabs(vp[i] - 0.04 * i) < 1e-9 && std::fabs(vd[i] - 0.04 * i) < 1e-9 &&
                 std::fabs(vu[i] - 0.04) < 1e-9;
        key_ok = key_ok && vk[i] == (i == 0 ? 1 : 0);  // default gop: only the first is key
        size_ok = size_ok && vs[i] > 0 && vs[i] < fi.file_size;
    }
    for (long i = 0; i < na && i < 64; i++) key_ok = key_ok && ak[i] == 1;
    if (!c.ok(nv == N && na > 0, "AVPacket.stream_index") || !c.ok(key_ok, "AVPacket.flags") ||
        !c.ok(size_ok, "AVPacket.size") || !c.ok(pts_ok, "AVPacket.pts"))
        return false;

    // frames: the planes written, at 0, 40, ... ms
    MPDecoder* d = mp_decoder_open_t(path.c_str(), 0.0, 0.0, 1, err, sizeof(err));
    if (!d) {
        c.failed = std::string("decoding the probe file: ") + err;
        return false;
    }
    std::vector<uint8_t> dy(N * W * H), du(u.size()), dv(v.size());
    double pts[N + 1];
    long got = mp_decoder_next_batch(d, dy.data(), du.data(), dv.data(), nullptr, N + 1, pts, err,
                                     sizeof(err));
    mp_decoder_close(d);
    bool planes_ok = got == N && dy == y && du == u && dv == v;
    bool fpts_ok = got == N;
    for (long i = 0; i < got && i < N; i++) fpts_ok = fpts_ok && std::fabs(pts[i] - 0.04 * i) < 1e-9;
    if (!c.ok(planes_ok, "AVFrame.data", "decoded planes differ") ||
        !c.ok(fpts_ok, "AVFrame.best_effort_timestamp", "decoded timestamps differ"))
        return false;

    // audio: the samples written, via swresample from the decoded frames
    std::vector<int16_t> back(NS * 2 + 64);
    int32_t rate = 0, chans = 0;
    long ns = mp_decode_audio_s16_ch(path.c_str(), 0.0, 0.0, 2, back.data(), NS + 32, &rate, &chans,
                                     err, sizeof(err));
    back.resize(ns > 0 ? (size_t)ns * 2 : 0);
    if (!c.ok(ns == NS && rate == RATE && chans == 2 && back == pcm, "AVFrame.sample_rate",
              "decoded audio differs") ||
        !c.ok(ns == NS && back == pcm, "AVFrame.extended_data", "decoded audio differs"))
        return false;
    remove(path.c_str());
    return true;
}

// AVBSFContext: init copies par_in and time_base_in into par_out and
// time_base_out, the fields right after them; h264_mp4toannexb, where it is
// bound, accepts the H.264 parameters put at par_in and refuses FFV1's.
// Where neither filter is bound the entries go unchecked and extraction is
// refused by the filter's name.
static bool check_bsf(Check& c) {
    const void* nullf = api.av_bsf_get_by_name("null");
    const void* annexb = api.av_bsf_get_by_name("h264_mp4toannexb");
    if (!nullf && !annexb) return true;
    const Codec* h264 = api.avcodec_find_decoder_by_name("h264");
    const Codec* ffv1 = api.avcodec_find_decoder_by_name("ffv1");
    if (!h264 || !ffv1) return true;
    auto params = [](const Codec* dec) {
        Ctx* ctx = api.avcodec_alloc_context3(dec);
        api.av_opt_set_image_size(ctx, "video_size", 48, 16, 0);
        Par* par = api.avcodec_parameters_alloc();
        api.avcodec_parameters_from_context(par, ctx);
        api.avcodec_free_context(&ctx);
        return par;
    };
    Par* ph = params(h264);
    Par* pf = params(ffv1);
    // init(filter, parameters): av_bsf_init's result and the filter's
    // par_out/time_base_out, read without trusting the offsets
    auto run = [&](const void* filter, Par* in, int* codec_out, int* width_out, Rational* tb_out) {
        Bsf* b = nullptr;
        if (api.av_bsf_alloc(filter, &b) < 0) return -1000;
        Par* pin = nullptr;
        int type = 0;
        Rational tb0{-1, -1};
        if (!safe_field(b, L->bsf_par_in, &pin) || !safe_field(pin, L->par_codec_type, &type) ||
            type != -1 || !safe_field(b, L->bsf_time_base_in, &tb0) || tb0.num != 0 || tb0.den != 0) {
            api.av_bsf_free(&b);
            return -1001;
        }
        api.avcodec_parameters_copy(pin, in);
        field<Rational>(b, L->bsf_time_base_in) = Rational{1, 90000};
        int ret = api.av_bsf_init(b);
        Par* pout = nullptr;
        if (ret == 0 && codec_out &&
            !(safe_field(b, L->bsf_par_in + (int)sizeof(void*), &pout) &&
              safe_field(pout, L->par_codec_id, codec_out) && safe_field(pout, L->par_width, width_out) &&
              safe_field(b, L->bsf_time_base_in + (int)sizeof(Rational), tb_out)))
            ret = -1002;
        api.av_bsf_free(&b);
        return ret;
    };
    int id = -1, w = -1;
    Rational tb{0, 0};
    int rc = run(nullf ? nullf : annexb, ph, &id, &w, &tb);
    bool par_ok = rc == 0 && id == field<int>(ph, L->par_codec_id) && w == 48;
    if (annexb)
        par_ok = par_ok && run(annexb, pf, nullptr, nullptr, nullptr) < 0 &&
                 run(annexb, ph, nullptr, nullptr, nullptr) == 0;
    api.avcodec_parameters_free(&ph);
    api.avcodec_parameters_free(&pf);
    return c.ok(par_ok, "AVBSFContext.par_in", "rc " + std::to_string(rc)) &&
           c.ok(rc == 0 && tb.num == 1 && tb.den == 90000, "AVBSFContext.time_base_in");
}

// One two-pass encode of a small clip through mp_encoder_open with the
// tentative stats_out/stats_in offsets: "ok", or what failed.
static std::string twopass_round_trip(const char* name, const char* opts, const std::string& dir) {
    const int W = 64, H = 64, N = 6;
    std::string out = dir + "/twopass_" + name + ".mkv", stats = dir + "/twopass_" + name + ".log";
    std::vector<uint8_t> y((size_t)N * W * H), u((size_t)N * W * H / 4), v(u.size());
    for (size_t i = 0; i < y.size(); i++) y[i] = (uint8_t)((i % W) * 3 + (i / (W * H)) * 11 + (i / W) % H);
    for (size_t i = 0; i < u.size(); i++) u[i] = (uint8_t)(128 + (i % 7)), v[i] = (uint8_t)(120 + (i % 5));
    char err[512] = {0};
    std::string verdict = "ok";
    for (int pass = 1; pass <= 2 && verdict == "ok"; pass++) {
        MPEncoder* e = mp_encoder_open(out.c_str(), name, W, H, "yuv420p", 25, 1, 200000, 0, 0, 0,
                                       -1, -1, 1, opts, pass, stats.c_str(), "", 0, 0, 0, err,
                                       sizeof(err));
        std::string tag = "pass" + std::to_string(pass);
        if (!e) {
            verdict = tag + "-open-failed";
            break;
        }
        bool wok = mp_encoder_write_video_batch(e, y.data(), u.data(), v.data(), nullptr, N, err,
                                                sizeof(err)) == N;
        if (mp_encoder_close(e, err, sizeof(err)) < 0 || !wok) verdict = tag + "-encode-failed";
        if (pass == 1 && verdict == "ok") {
            FILE* f = fopen(stats.c_str(), "rb");
            long n = -1;
            if (f && fseek(f, 0, SEEK_END) == 0) n = ftell(f);
            if (f) fclose(f);
            if (n <= 0) verdict = "no-pass1-statistics";
        }
    }
    if (verdict == "ok") {
        std::vector<int64_t> sizes(64);
        std::vector<double> a(64), b(64), d(64);
        std::vector<int8_t> k(64);
        long n = mp_scan_packets(out.c_str(), 0, sizes.data(), a.data(), b.data(), d.data(), k.data(),
                                 64, err, sizeof(err));
        if (n <= 0) verdict = "no-pass2-packets";
    }
    remove(out.c_str());
    remove(stats.c_str());
    return verdict;
}

// stats_out and stats_in: the two pointers right before the "bug" option's
// field, null on a fresh context. Each libvpx/libaom encoder bound runs a
// two-pass round trip with them; one that passes proves them, and an
// encoder whose round trip fails keeps its verdict, which refuses its
// two-pass by name. No round trip passing leaves them unproven, and
// two-pass is then refused for every encoder that needs them.
static void check_twopass(Check& c, const std::string& dir) {
    Ctx* probe = api.avcodec_alloc_context3(nullptr);
    void* target = nullptr;
    const void* opt = api.av_opt_find2(probe, "bug", nullptr, 0, 0, &target);
    int bug = opt ? field<int>(opt, 2 * (int)sizeof(void*)) : -1;
    char* so = reinterpret_cast<char*>(1);
    char* si = reinterpret_cast<char*>(1);
    bool fresh = bug >= 16 && safe_field(probe, bug - 16, &so) && safe_field(probe, bug - 8, &si) &&
                 !so && !si;
    api.avcodec_free_context(&probe);
    struct T { const char* name; const char* opts; };
    bool proven = false;
    g_twopass.clear();
    for (T t : {T{"libvpx-vp9", "speed=8:row-mt=1"}, T{"libaom-av1", "cpu-used=8:usage=realtime"}}) {
        std::string verdict;
        if (!api.avcodec_find_encoder_by_name(t.name)) {
            verdict = "absent";
        } else if (!fresh) {
            verdict = "unproven-offsets";
        } else {
            g_ctx_stats_out_off = bug - 16;
            g_ctx_stats_in_off = bug - 8;
            verdict = twopass_round_trip(t.name, t.opts, dir);
            proven = proven || verdict == "ok";
        }
        g_twopass += (g_twopass.empty() ? "" : " ") + std::string(t.name) + "=" + verdict;
    }
    if (!proven) {
        g_ctx_stats_out_off = g_ctx_stats_in_off = -1;
        return;
    }
    *c.report += "AVCodecContext.stats_out@" + std::to_string(g_ctx_stats_out_off) +
                 " AVCodecContext.stats_in@" + std::to_string(g_ctx_stats_in_off) + " ";
}

// Runs every round trip of the bound table, writing its scratch files under
// `dir`. report receives "Field@offset " for each entry that passed.
// Returns the number of checks passed, or -1 with the first failing field
// named in err.
EXPORT int mp_check(const char* dir, char* report, int report_len, char* err, int errlen) {
    if (!g_bound) {
        set_err(err, errlen, "mp_check before mp_bind");
        return -1;
    }
    if (g_ctx_coded_off < 0) {
        Ctx* probe = api.avcodec_alloc_context3(nullptr);
        void* target = nullptr;
        const void* opt = api.av_opt_find2(probe, "video_size", nullptr, 0, 0, &target);
        // AVOption: name, help, then int offset
        if (opt) g_ctx_coded_off = field<int>(opt, 2 * (int)sizeof(void*)) + 8;
        api.avcodec_free_context(&probe);
        if (!opt) {
            set_err(err, errlen, "AVCodecContext has no \"video_size\" option");
            return -1;
        }
    }
    std::string rep;
    Check c;
    c.report = &rep;
    bool ok = check_structs(c, dir) && check_file(c, dir);
    // the BSF refusal and the encoders' banners are expected: keep them
    // off stderr
    int level = api.av_log_get_level();
    api.av_log_set_level(-8);  // AV_LOG_QUIET
    ok = ok && check_bsf(c);
    if (ok) check_twopass(c, dir);
    api.av_log_set_level(level);
    set_err(report, report_len, rep);
    if (!ok) {
        set_err(err, errlen, c.failed.empty() ? std::string("layout check failed") : c.failed);
        return -1;
    }
    return c.passed;
}
