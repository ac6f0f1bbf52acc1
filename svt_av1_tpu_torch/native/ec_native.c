/*
 * Python-facing wrapper over the native range coder core (ec_core.h).
 *
 * CDF arrays are the same numpy uint16 icdf(+counter) buffers the Python
 * side uses; adaptation happens in place so both paths interoperate.
 * Equivalence with entropy/ec.py + coeffs.py is enforced by
 * tests/test_native_ec.py.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include "ec_core.h"

typedef struct {
    PyObject_HEAD
    EcCore core;
} EcEncObject;

/* ------------------------------------------------------------------ */
/* Python object machinery                                            */
/* ------------------------------------------------------------------ */

static PyObject *EcEnc_new(PyTypeObject *type, PyObject *args, PyObject *kw) {
    EcEncObject *self = (EcEncObject *)type->tp_alloc(type, 0);
    if (!self) return NULL;
    if (ec_core_init(&self->core) < 0) {
        Py_DECREF(self);
        return PyErr_NoMemory();
    }
    return (PyObject *)self;
}

static void EcEnc_dealloc(EcEncObject *self) {
    ec_core_free(&self->core);
    Py_TYPE(self)->tp_free((PyObject *)self);
}

static int get_u16_buffer(PyObject *obj, Py_buffer *view, uint16_t **data,
                          Py_ssize_t *len) {
    if (PyObject_GetBuffer(obj, view, PyBUF_C_CONTIGUOUS | PyBUF_WRITABLE) < 0)
        return -1;
    if (view->itemsize != 2) {
        PyBuffer_Release(view);
        PyErr_SetString(PyExc_TypeError, "expected uint16 buffer");
        return -1;
    }
    *data = (uint16_t *)view->buf;
    *len = view->len / 2;
    return 0;
}

static PyObject *EcEnc_encode_symbol(EcEncObject *self, PyObject *args) {
    int s, nsyms;
    PyObject *cdf_obj;
    int adapt = 1;
    if (!PyArg_ParseTuple(args, "iOi|p", &s, &cdf_obj, &nsyms, &adapt))
        return NULL;
    Py_buffer view;
    uint16_t *cdf;
    Py_ssize_t len;
    if (get_u16_buffer(cdf_obj, &view, &cdf, &len) < 0) return NULL;
    enc_cdf(&self->core, s, cdf, nsyms);
    if (adapt) ec_update_cdf(cdf, s, nsyms);
    PyBuffer_Release(&view);
    Py_RETURN_NONE;
}

static PyObject *EcEnc_encode_bool_prob8(EcEncObject *self, PyObject *args) {
    int bit, prob8;
    if (!PyArg_ParseTuple(args, "ii", &bit, &prob8)) return NULL;
    uint32_t f = (0x7FFFFFu - ((uint32_t)prob8 << 15) + (uint32_t)prob8) >> 8;
    enc_bool_q15(&self->core, bit, f);
    Py_RETURN_NONE;
}

static PyObject *EcEnc_encode_literal(EcEncObject *self, PyObject *args) {
    unsigned int value;
    int bits;
    if (!PyArg_ParseTuple(args, "Ii", &value, &bits)) return NULL;
    for (int b = bits - 1; b >= 0; --b) enc_bit(&self->core, (value >> b) & 1);
    Py_RETURN_NONE;
}

static PyObject *EcEnc_tell_bits(EcEncObject *self, PyObject *noarg) {
    return PyLong_FromLongLong(ec_core_tell_bits(&self->core));
}

static PyObject *EcEnc_done(EcEncObject *self, PyObject *noarg) {
    size_t cap = self->core.offs + 8;
    unsigned char *tmp = (unsigned char *)malloc(cap);
    if (!tmp) return PyErr_NoMemory();
    size_t total = ec_core_done(&self->core, tmp);
    PyObject *out = PyBytes_FromStringAndSize((const char *)tmp,
                                              (Py_ssize_t)total);
    free(tmp);
    return out;
}

/*
 * write_coeffs(qcoeff int32[h*w], scan int16[n], eob, w, h, tx_class,
 *              eob_pt_cdf row, eob_extra_cdf row,
 *              base_cdf [n_ctx][5], base_eob_cdf [n_ctx][4],
 *              br_cdf [n_ctx][5], dc_sign_cdf row) -> cul_level
 */
static PyObject *EcEnc_write_coeffs(EcEncObject *self, PyObject *args) {
    Py_buffer qv, sv, ev, xv, bv, bev, brv, dv;
    int eob, w, h, tx_class, base_stride, base_eob_stride, br_stride;
    int shape = -1;   /* tall/wide rule from the TRUE tx dims (64-dim
                         sizes clamp w/h to 32 but keep their shape) */
    if (!PyArg_ParseTuple(args, "y*y*iiiiw*w*w*iw*iw*iw*|i",
                          &qv, &sv, &eob, &w, &h, &tx_class,
                          &ev, &xv, &bv, &base_stride, &bev, &base_eob_stride,
                          &brv, &br_stride, &dv, &shape))
        return NULL;
    long long cul_level = ec_write_coeffs_core(
        &self->core, (const int32_t *)qv.buf, (const int16_t *)sv.buf,
        eob, w, h, tx_class,
        (uint16_t *)ev.buf, (uint16_t *)xv.buf,
        (uint16_t *)bv.buf, base_stride,
        (uint16_t *)bev.buf, base_eob_stride,
        (uint16_t *)brv.buf, br_stride,
        (uint16_t *)dv.buf, shape);
    PyBuffer_Release(&qv); PyBuffer_Release(&sv);
    PyBuffer_Release(&ev); PyBuffer_Release(&xv); PyBuffer_Release(&bv);
    PyBuffer_Release(&bev); PyBuffer_Release(&brv); PyBuffer_Release(&dv);
    return PyLong_FromLongLong(cul_level);
}

static PyMethodDef EcEnc_methods[] = {
    {"encode_symbol", (PyCFunction)EcEnc_encode_symbol, METH_VARARGS, NULL},
    {"encode_bool_prob8", (PyCFunction)EcEnc_encode_bool_prob8, METH_VARARGS, NULL},
    {"encode_literal", (PyCFunction)EcEnc_encode_literal, METH_VARARGS, NULL},
    {"write_coeffs", (PyCFunction)EcEnc_write_coeffs, METH_VARARGS, NULL},
    {"tell_bits", (PyCFunction)EcEnc_tell_bits, METH_NOARGS, NULL},
    {"done", (PyCFunction)EcEnc_done, METH_NOARGS, NULL},
    {NULL, NULL, 0, NULL},
};

static PyTypeObject EcEncType = {
    PyVarObject_HEAD_INIT(NULL, 0)
    .tp_name = "ec_native.EcEnc",
    .tp_basicsize = sizeof(EcEncObject),
    .tp_flags = Py_TPFLAGS_DEFAULT,
    .tp_new = EcEnc_new,
    .tp_dealloc = (destructor)EcEnc_dealloc,
    .tp_methods = EcEnc_methods,
};

static PyModuleDef ec_native_module = {
    PyModuleDef_HEAD_INIT, "ec_native",
    "Native AV1 range coder / coefficient packer", -1, NULL,
};

PyMODINIT_FUNC PyInit_ec_native(void) {
    PyObject *m;
    if (PyType_Ready(&EcEncType) < 0) return NULL;
    m = PyModule_Create(&ec_native_module);
    if (!m) return NULL;
    Py_INCREF(&EcEncType);
    PyModule_AddObject(m, "EcEnc", (PyObject *)&EcEncType);
    return m;
}
