/* fastpath.c — native control-plane codec for ray_tpu_torch (copy of the
 * JAX package's src/fastpath/fastpath.c, built as ``ray_tpu_torch_fastpath``
 * so both packages' extensions can load into one process).
 *
 * Reference analogue: the hot-loop frame/codec work the reference does in
 * C++ with the GIL dropped (src/ray/rpc/ + _raylet.pyx:2942). This module
 * implements the per-call byte work of the Python control plane:
 *
 *   - RPC frame header pack/unpack        ([u32 total][u64 call_id][u8 kind])
 *   - out-of-band body encode/decode      ([u32 meta_len][meta][u32 nbuf]
 *                                          ([u64 blen][payload])*)
 *   - single-pass frame layout into a caller mapping (the plasma
 *     Create→write-in-place→Seal path), releasing the GIL around memcpy
 *   - deterministic ID derivation (ObjectID::FromIndex)
 *
 * Contract: every function here has a byte-identical pure-Python fallback
 * in ray_tpu_torch/_private/fastpath/_pyimpl.py; tests/test_torch_fastpath.py
 * holds both against each other and against the JAX package's extension.
 * Change the wire layout in every place or not at all.
 *
 * The source is C that is also valid C++, so a host whose only compiler is
 * g++ builds it too (the Makefile's CC).
 *
 * One departure from the JAX package's copy: the integer fields (a header's
 * total and call_id, build_frame's call_id, id_from_index's index) are
 * range-checked and raise OverflowError, as the Python backend's struct
 * packing raises; the "I"/"K" argument formats there wrap them silently.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>

/* payload bytes above which the copy loops drop the GIL */
#define FASTPATH_NOGIL_THRESHOLD (64 * 1024)

/* ---------------------------------------------------------------- utils */

static inline void
put_u32le(uint8_t *p, uint32_t v)
{
    p[0] = (uint8_t)(v & 0xff);
    p[1] = (uint8_t)((v >> 8) & 0xff);
    p[2] = (uint8_t)((v >> 16) & 0xff);
    p[3] = (uint8_t)((v >> 24) & 0xff);
}

static inline void
put_u64le(uint8_t *p, uint64_t v)
{
    int i;
    for (i = 0; i < 8; i++)
        p[i] = (uint8_t)((v >> (8 * i)) & 0xff);
}

static inline uint32_t
get_u32le(const uint8_t *p)
{
    return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
           ((uint32_t)p[3] << 24);
}

static inline uint64_t
get_u64le(const uint8_t *p)
{
    uint64_t v = 0;
    int i;
    for (i = 7; i >= 0; i--)
        v = (v << 8) | p[i];
    return v;
}

/* Collect 1-D contiguous buffer views for a sequence of buffer-protocol
 * objects. Returns 0 on success; caller must release the first *filled
 * views on any exit. */
static int
collect_buffers(PyObject *seq, Py_buffer **views_out, Py_ssize_t *n_out,
                uint64_t *payload_out)
{
    PyObject *fast = PySequence_Fast(seq, "bufs must be a sequence");
    if (fast == NULL)
        return -1;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
    Py_buffer *views = NULL;
    if (n > 0) {
        views = (Py_buffer *)PyMem_Calloc((size_t)n, sizeof(Py_buffer));
        if (views == NULL) {
            Py_DECREF(fast);
            PyErr_NoMemory();
            return -1;
        }
    }
    uint64_t payload = 0;
    Py_ssize_t i;
    for (i = 0; i < n; i++) {
        PyObject *item = PySequence_Fast_GET_ITEM(fast, i);
        if (PyObject_GetBuffer(item, &views[i], PyBUF_SIMPLE) != 0) {
            Py_ssize_t j;
            for (j = 0; j < i; j++)
                PyBuffer_Release(&views[j]);
            PyMem_Free(views);
            Py_DECREF(fast);
            return -1;
        }
        payload += (uint64_t)views[i].len;
    }
    Py_DECREF(fast);
    *views_out = views;
    *n_out = n;
    *payload_out = payload;
    return 0;
}

static void
release_buffers(Py_buffer *views, Py_ssize_t n)
{
    Py_ssize_t i;
    for (i = 0; i < n; i++)
        PyBuffer_Release(&views[i]);
    PyMem_Free(views);
}

/* mv[start:stop] — owns its temporaries (PySlice_New does not steal). */
static PyObject *
slice_view(PyObject *mv, Py_ssize_t start, Py_ssize_t stop)
{
    PyObject *lo = PyLong_FromSsize_t(start);
    PyObject *hi = PyLong_FromSsize_t(stop);
    if (lo == NULL || hi == NULL) {
        Py_XDECREF(lo);
        Py_XDECREF(hi);
        return NULL;
    }
    PyObject *slice = PySlice_New(lo, hi, NULL);
    Py_DECREF(lo);
    Py_DECREF(hi);
    if (slice == NULL)
        return NULL;
    PyObject *out = PyObject_GetItem(mv, slice);
    Py_DECREF(slice);
    return out;
}

/* Lay the OOB body ([u32 meta_len][meta][u32 nbuf]([u64 blen][payload])*)
 * into dst. dst must hold 8 + meta_len + sum(8 + blen) bytes. Releases
 * the GIL around the copy loop when the payload is large. */
static void
write_body(uint8_t *dst, const uint8_t *meta, Py_ssize_t meta_len,
           Py_buffer *views, Py_ssize_t nbuf, uint64_t payload)
{
    if (payload >= FASTPATH_NOGIL_THRESHOLD) {
        Py_BEGIN_ALLOW_THREADS;
        uint8_t *p = dst;
        Py_ssize_t i;
        put_u32le(p, (uint32_t)meta_len);
        p += 4;
        memcpy(p, meta, (size_t)meta_len);
        p += meta_len;
        put_u32le(p, (uint32_t)nbuf);
        p += 4;
        for (i = 0; i < nbuf; i++) {
            put_u64le(p, (uint64_t)views[i].len);
            p += 8;
            memcpy(p, views[i].buf, (size_t)views[i].len);
            p += views[i].len;
        }
        Py_END_ALLOW_THREADS;
    } else {
        uint8_t *p = dst;
        Py_ssize_t i;
        put_u32le(p, (uint32_t)meta_len);
        p += 4;
        memcpy(p, meta, (size_t)meta_len);
        p += meta_len;
        put_u32le(p, (uint32_t)nbuf);
        p += 4;
        for (i = 0; i < nbuf; i++) {
            put_u64le(p, (uint64_t)views[i].len);
            p += 8;
            memcpy(p, views[i].buf, (size_t)views[i].len);
            p += views[i].len;
        }
    }
}

/* A Python int in [0, max] as a uint64_t; OverflowError (or TypeError for
 * a non-int) otherwise. Returns 0 on success. */
static int
as_u64(PyObject *obj, uint64_t max, uint64_t *out, const char *what)
{
    unsigned long long v = PyLong_AsUnsignedLongLong(obj);
    if (v == (unsigned long long)-1 && PyErr_Occurred())
        return -1;
    if ((uint64_t)v > max) {
        PyErr_Format(PyExc_OverflowError, "%s out of range", what);
        return -1;
    }
    *out = (uint64_t)v;
    return 0;
}

/* ------------------------------------------------------------- header */

static PyObject *
fp_pack_header(PyObject *self, PyObject *args)
{
    PyObject *total_obj, *call_id_obj;
    uint64_t total, call_id;
    int kind;
    (void)self;
    if (!PyArg_ParseTuple(args, "OOi", &total_obj, &call_id_obj, &kind))
        return NULL;
    if (as_u64(total_obj, UINT32_MAX, &total, "total") != 0 ||
        as_u64(call_id_obj, UINT64_MAX, &call_id, "call_id") != 0)
        return NULL;
    if (kind < 0 || kind > 255) {
        PyErr_SetString(PyExc_ValueError, "kind must be 0..255");
        return NULL;
    }
    PyObject *out = PyBytes_FromStringAndSize(NULL, 13);
    if (out == NULL)
        return NULL;
    uint8_t *p = (uint8_t *)PyBytes_AS_STRING(out);
    put_u32le(p, (uint32_t)total);
    put_u64le(p + 4, (uint64_t)call_id);
    p[12] = (uint8_t)kind;
    return out;
}

static PyObject *
fp_unpack_header(PyObject *self, PyObject *args)
{
    Py_buffer view;
    (void)self;
    if (!PyArg_ParseTuple(args, "y*", &view))
        return NULL;
    if (view.len < 13) {
        PyBuffer_Release(&view);
        PyErr_SetString(PyExc_ValueError, "frame header needs 13 bytes");
        return NULL;
    }
    const uint8_t *p = (const uint8_t *)view.buf;
    uint32_t total = get_u32le(p);
    uint64_t call_id = get_u64le(p + 4);
    int kind = p[12];
    PyBuffer_Release(&view);
    return Py_BuildValue("(IKi)", total, (unsigned long long)call_id, kind);
}

/* --------------------------------------------------------------- body */

static PyObject *
fp_encode_body(PyObject *self, PyObject *args)
{
    Py_buffer meta;
    PyObject *bufs;
    (void)self;
    if (!PyArg_ParseTuple(args, "y*O", &meta, &bufs))
        return NULL;
    Py_buffer *views = NULL;
    Py_ssize_t nbuf = 0;
    uint64_t payload = 0;
    if (collect_buffers(bufs, &views, &nbuf, &payload) != 0) {
        PyBuffer_Release(&meta);
        return NULL;
    }
    Py_ssize_t total =
        8 + meta.len + (Py_ssize_t)(nbuf * 8) + (Py_ssize_t)payload;
    PyObject *out = PyBytes_FromStringAndSize(NULL, total);
    if (out == NULL) {
        release_buffers(views, nbuf);
        PyBuffer_Release(&meta);
        return NULL;
    }
    write_body((uint8_t *)PyBytes_AS_STRING(out), (const uint8_t *)meta.buf,
               meta.len, views, nbuf, payload);
    release_buffers(views, nbuf);
    PyBuffer_Release(&meta);
    return out;
}

static PyObject *
fp_write_body_into(PyObject *self, PyObject *args)
{
    PyObject *dest;
    Py_buffer meta;
    PyObject *bufs;
    (void)self;
    if (!PyArg_ParseTuple(args, "Oy*O", &dest, &meta, &bufs))
        return NULL;
    Py_buffer dview;
    if (PyObject_GetBuffer(dest, &dview, PyBUF_WRITABLE) != 0) {
        PyBuffer_Release(&meta);
        return NULL;
    }
    Py_buffer *views = NULL;
    Py_ssize_t nbuf = 0;
    uint64_t payload = 0;
    if (collect_buffers(bufs, &views, &nbuf, &payload) != 0) {
        PyBuffer_Release(&dview);
        PyBuffer_Release(&meta);
        return NULL;
    }
    Py_ssize_t total =
        8 + meta.len + (Py_ssize_t)(nbuf * 8) + (Py_ssize_t)payload;
    if (dview.len < total) {
        release_buffers(views, nbuf);
        PyBuffer_Release(&dview);
        PyBuffer_Release(&meta);
        PyErr_SetString(PyExc_ValueError,
                        "destination smaller than frame total");
        return NULL;
    }
    write_body((uint8_t *)dview.buf, (const uint8_t *)meta.buf, meta.len,
               views, nbuf, payload);
    release_buffers(views, nbuf);
    PyBuffer_Release(&dview);
    PyBuffer_Release(&meta);
    return PyLong_FromSsize_t(total);
}

/* decode_body(body) -> (meta_view, [buf_view, ...]) — zero-copy
 * memoryview slices of the input object. */
static PyObject *
fp_decode_body(PyObject *self, PyObject *args)
{
    PyObject *body;
    (void)self;
    if (!PyArg_ParseTuple(args, "O", &body))
        return NULL;
    PyObject *mv = PyMemoryView_FromObject(body);
    if (mv == NULL)
        return NULL;
    Py_buffer *view = PyMemoryView_GET_BUFFER(mv);
    if (!PyBuffer_IsContiguous(view, 'C') || view->ndim > 1) {
        Py_DECREF(mv);
        PyErr_SetString(PyExc_ValueError, "body must be 1-D contiguous");
        return NULL;
    }
    const uint8_t *base = (const uint8_t *)view->buf;
    Py_ssize_t len = view->len;
    PyObject *meta_view = NULL, *out = NULL, *lst = NULL;
    /* declared before the first goto: C++ forbids jumping past them */
    uint32_t meta_len, nbuf;
    Py_ssize_t off;

    if (len < 8)
        goto truncated;
    meta_len = get_u32le(base);
    off = 4;
    if ((uint64_t)meta_len + 4 > (uint64_t)(len - off))
        goto truncated;
    meta_view = slice_view(mv, off, off + (Py_ssize_t)meta_len);
    if (meta_view == NULL)
        goto fail;
    off += (Py_ssize_t)meta_len;
    nbuf = get_u32le(base + off);
    off += 4;
    lst = PyList_New((Py_ssize_t)nbuf);
    if (lst == NULL)
        goto fail;
    {
        uint32_t i;
        for (i = 0; i < nbuf; i++) {
            if (off + 8 > len)
                goto truncated;
            uint64_t blen = get_u64le(base + off);
            off += 8;
            /* unsigned compare BEFORE any cast: a corrupt frame's huge
             * u64 length must not wrap Py_ssize_t negative and slip
             * past the bounds check into out-of-bounds reads */
            if (blen > (uint64_t)(len - off))
                goto truncated;
            PyObject *bview =
                slice_view(mv, off, off + (Py_ssize_t)blen);
            if (bview == NULL)
                goto fail;
            PyList_SET_ITEM(lst, (Py_ssize_t)i, bview);
            off += (Py_ssize_t)blen;
        }
    }
    out = PyTuple_Pack(2, meta_view, lst);
    Py_DECREF(meta_view);
    Py_DECREF(lst);
    Py_DECREF(mv);
    return out;

truncated:
    PyErr_SetString(PyExc_ValueError, "truncated out-of-band body");
fail:
    Py_XDECREF(meta_view);
    Py_XDECREF(lst);
    Py_DECREF(mv);
    return NULL;
}

/* build_frame(call_id, kind, body) -> bytes: 13-byte header + body in one
 * allocation — the small-frame assembly path. */
static PyObject *
fp_build_frame(PyObject *self, PyObject *args)
{
    PyObject *call_id_obj;
    uint64_t call_id;
    int kind;
    Py_buffer body;
    (void)self;
    if (!PyArg_ParseTuple(args, "Oiy*", &call_id_obj, &kind, &body))
        return NULL;
    if (as_u64(call_id_obj, UINT64_MAX, &call_id, "call_id") != 0) {
        PyBuffer_Release(&body);
        return NULL;
    }
    if (kind < 0 || kind > 255) {
        PyBuffer_Release(&body);
        PyErr_SetString(PyExc_ValueError, "kind must be 0..255");
        return NULL;
    }
    PyObject *out = PyBytes_FromStringAndSize(NULL, 13 + body.len);
    if (out == NULL) {
        PyBuffer_Release(&body);
        return NULL;
    }
    uint8_t *p = (uint8_t *)PyBytes_AS_STRING(out);
    put_u32le(p, (uint32_t)body.len);
    put_u64le(p + 4, (uint64_t)call_id);
    p[12] = (uint8_t)kind;
    if (body.len >= FASTPATH_NOGIL_THRESHOLD) {
        Py_BEGIN_ALLOW_THREADS;
        memcpy(p + 13, body.buf, (size_t)body.len);
        Py_END_ALLOW_THREADS;
    } else {
        memcpy(p + 13, body.buf, (size_t)body.len);
    }
    PyBuffer_Release(&body);
    return out;
}

/* ----------------------------------------------------------------- ids */

static PyObject *
fp_id_from_index(PyObject *self, PyObject *args)
{
    Py_buffer prefix;
    PyObject *index_obj;
    uint64_t index;
    (void)self;
    if (!PyArg_ParseTuple(args, "y*O", &prefix, &index_obj))
        return NULL;
    if (as_u64(index_obj, UINT32_MAX, &index, "index") != 0) {
        PyBuffer_Release(&prefix);
        return NULL;
    }
    PyObject *out = PyBytes_FromStringAndSize(NULL, prefix.len + 4);
    if (out == NULL) {
        PyBuffer_Release(&prefix);
        return NULL;
    }
    uint8_t *p = (uint8_t *)PyBytes_AS_STRING(out);
    memcpy(p, prefix.buf, (size_t)prefix.len);
    put_u32le(p + prefix.len, (uint32_t)index);
    PyBuffer_Release(&prefix);
    return out;
}

/* ------------------------------------------------------------- module */

static PyMethodDef fastpath_methods[] = {
    {"pack_header", fp_pack_header, METH_VARARGS,
     "pack_header(total, call_id, kind) -> 13-byte frame header"},
    {"unpack_header", fp_unpack_header, METH_VARARGS,
     "unpack_header(buf) -> (total, call_id, kind)"},
    {"encode_body", fp_encode_body, METH_VARARGS,
     "encode_body(meta, bufs) -> out-of-band body bytes"},
    {"write_body_into", fp_write_body_into, METH_VARARGS,
     "write_body_into(dest, meta, bufs) -> bytes written (GIL-released "
     "memcpy for large payloads)"},
    {"decode_body", fp_decode_body, METH_VARARGS,
     "decode_body(body) -> (meta_view, [buffer views]) zero-copy"},
    {"build_frame", fp_build_frame, METH_VARARGS,
     "build_frame(call_id, kind, body) -> header+body bytes"},
    {"id_from_index", fp_id_from_index, METH_VARARGS,
     "id_from_index(prefix, index) -> prefix + u32le(index)"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef fastpath_module = {
    PyModuleDef_HEAD_INIT,
    "ray_tpu_torch_fastpath",
    "Native control-plane frame/codec fast path for ray_tpu_torch.",
    -1,
    fastpath_methods,
    NULL,
    NULL,
    NULL,
    NULL,
};

PyMODINIT_FUNC
PyInit_ray_tpu_torch_fastpath(void)
{
    PyObject *m = PyModule_Create(&fastpath_module);
    if (m == NULL)
        return NULL;
    PyModule_AddIntConstant(m, "NOGIL_THRESHOLD", FASTPATH_NOGIL_THRESHOLD);
    PyModule_AddStringConstant(m, "BACKEND", "c");
    return m;
}
