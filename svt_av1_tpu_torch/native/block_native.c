/*
 * Python-facing wrapper for the fused per-block coding kernel
 * (block_core.h): forward transform -> quantize_b -> eob -> dequant ->
 * inverse transform -> reconstruction, in one call.
 *
 * The sequential encode pass is the one place the TPU build keeps a
 * native host component, mirroring the reference's role split (SURVEY
 * §7: serial CPU hot loop).  Equivalence with the Python pipeline is
 * enforced by tests/test_native_block.py.
 *
 * Python-facing API:
 *   plan = make_plan(ints_tuple, arrays_tuple)   -> capsule
 *   code_block(plan, resid_i32, pred_i32, qc_out_i32, recon_out_i32)
 *       -> eob (int)
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include "block_core.h"

static void plan_free(PyObject *cap) {
    Plan *p = (Plan *)PyCapsule_GetPointer(cap, "block_plan");
    if (p) { Py_XDECREF((PyObject *)p->refs); PyMem_Free(p); }
}

static const void *buf_of(PyObject *seq, Py_ssize_t i) {
    PyObject *o = PyTuple_GET_ITEM(seq, i);
    Py_buffer view;
    if (PyObject_GetBuffer(o, &view, PyBUF_SIMPLE) < 0) return NULL;
    const void *p = view.buf;
    PyBuffer_Release(&view);   /* arrays stay alive via plan->refs */
    return p;
}

/* ints: w h bd fs0 fs1 fs2 is0 is1 fvflip fhflip rect icl_row icl_col
 *       fcol_cos fcol_kind frow_cos frow_kind irow_cos irow_kind
 *       icol_cos icol_kind log_scale n_scan cw ch
 * arrays: fcol(stmts offs clamp cospi) frow(...) irow(...) icol(...)
 *         sinpi_f sinpi_i zbin rnd quant qshift dequant scan          */
static PyObject *make_plan(PyObject *self, PyObject *args) {
    PyObject *ints, *arrays;
    if (!PyArg_ParseTuple(args, "OO", &ints, &arrays)) return NULL;
    Plan *p = (Plan *)PyMem_Calloc(1, sizeof(Plan));
    if (!p) return PyErr_NoMemory();
    long iv[25];
    for (int i = 0; i < 25; ++i)
        iv[i] = PyLong_AsLong(PyTuple_GET_ITEM(ints, i));
    p->w = iv[0]; p->h = iv[1]; p->bd = iv[2];
    p->fs0 = iv[3]; p->fs1 = iv[4]; p->fs2 = iv[5];
    p->is0 = iv[6]; p->is1 = iv[7];
    p->fwd_flip_v = iv[8]; p->fwd_flip_h = iv[9]; p->rect = iv[10];
    p->inv_clamp_row = iv[11]; p->inv_clamp_col = iv[12];
    Net1d *nets[4] = {&p->fcol, &p->frow, &p->irow, &p->icol};
    for (int k = 0; k < 4; ++k) {
        nets[k]->cos_bit = iv[13 + 2 * k];
        nets[k]->kind = iv[14 + 2 * k];
    }
    p->fcol.n = p->h; p->frow.n = p->w;
    p->irow.n = p->w; p->icol.n = p->h;
    p->log_scale = iv[21];
    p->n_scan = iv[22]; p->cw = iv[23]; p->ch = iv[24];

    for (int k = 0; k < 4; ++k) {
        nets[k]->stmts = (const int32_t *)buf_of(arrays, 4 * k + 0);
        nets[k]->offs = (const int32_t *)buf_of(arrays, 4 * k + 1);
        nets[k]->clamp = (const int8_t *)buf_of(arrays, 4 * k + 2);
        nets[k]->cospi = (const int32_t *)buf_of(arrays, 4 * k + 3);
        PyObject *offs_o = PyTuple_GET_ITEM(arrays, 4 * k + 1);
        Py_buffer v;
        PyObject_GetBuffer(offs_o, &v, PyBUF_SIMPLE);
        nets[k]->n_stages = v.len / 4 - 1;
        PyBuffer_Release(&v);
    }
    p->sinpi = (const int32_t *)buf_of(arrays, 16);
    p->sinpi_inv = (const int32_t *)buf_of(arrays, 17);
    const int32_t *q;
    q = (const int32_t *)buf_of(arrays, 18); p->zbin[0] = q[0]; p->zbin[1] = q[1];
    q = (const int32_t *)buf_of(arrays, 19); p->rnd[0] = q[0]; p->rnd[1] = q[1];
    q = (const int32_t *)buf_of(arrays, 20); p->quant[0] = q[0]; p->quant[1] = q[1];
    q = (const int32_t *)buf_of(arrays, 21); p->qshift[0] = q[0]; p->qshift[1] = q[1];
    q = (const int32_t *)buf_of(arrays, 22); p->dequant[0] = q[0]; p->dequant[1] = q[1];
    p->scan = (const int16_t *)buf_of(arrays, 23);
    q = (const int32_t *)buf_of(arrays, 24); p->quant_fp[0] = q[0]; p->quant_fp[1] = q[1];
    q = (const int32_t *)buf_of(arrays, 25); p->rnd_fp[0] = q[0]; p->rnd_fp[1] = q[1];
    Py_INCREF(arrays);
    p->refs = (void *)arrays;
    return PyCapsule_New(p, "block_plan", plan_free);
}

/* tabs: 7 contiguous int32 arrays already sliced to this txb's
 * contexts: txb_skip_row[2], base_eob[4*3], base[42*8],
 * eob_extra[22*2], dc_sign_row[2], lps[21*26], eob_cost[2*11] */
static int fill_rdoq(RdoqRun *rr, PyObject *tabs, long long rdmult,
                     long tx_class, long shape, long use_fp) {
    rr->txb_skip = (const int32_t *)buf_of(tabs, 0);
    rr->base_eob = (const int32_t *)buf_of(tabs, 1);
    rr->base = (const int32_t *)buf_of(tabs, 2);
    rr->eob_extra = (const int32_t *)buf_of(tabs, 3);
    rr->dc_sign = (const int32_t *)buf_of(tabs, 4);
    rr->lps = (const int32_t *)buf_of(tabs, 5);
    rr->eob_cost = (const int32_t *)buf_of(tabs, 6);
    rr->rdmult = rdmult;
    rr->tx_class = (int)tx_class;
    rr->shape = (int)shape;
    rr->use_fp = (int)use_fp;
    return rr->txb_skip && rr->base_eob && rr->base && rr->eob_extra
        && rr->dc_sign && rr->lps && rr->eob_cost;
}

static PyObject *code_block_rdoq(PyObject *self, PyObject *args) {
    PyObject *cap, *tabs;
    Py_buffer rv, pv, qv, ov;
    long long rdmult;
    long tx_class, shape, use_fp;
    if (!PyArg_ParseTuple(args, "Oy*y*w*w*OLlll", &cap, &rv, &pv, &qv,
                          &ov, &tabs, &rdmult, &tx_class, &shape,
                          &use_fp))
        return NULL;
    Plan *p = (Plan *)PyCapsule_GetPointer(cap, "block_plan");
    RdoqRun rr;
    int ok = p && fill_rdoq(&rr, tabs, rdmult, tx_class, shape, use_fp);
    int eob = ok ? block_code_core_rdoq(p, (const int32_t *)rv.buf,
                                        (const int32_t *)pv.buf,
                                        (int32_t *)qv.buf,
                                        (int32_t *)ov.buf, &rr)
                 : 0;
    PyBuffer_Release(&rv); PyBuffer_Release(&pv);
    PyBuffer_Release(&qv); PyBuffer_Release(&ov);
    if (!ok) return NULL;
    return PyLong_FromLong(eob);
}

/* standalone trellis entry for equivalence tests:
 * rdoq_txb(tq, q, dq, eob, scan, cw, ch, deq_dc, deq_ac, shift,
 *          tabs, rdmult, tx_class, shape) -> new eob */
static PyObject *rdoq_txb(PyObject *self, PyObject *args) {
    Py_buffer tqv, qv, dqv, scanv;
    long eob, cw, ch, deq_dc, deq_ac, shift, tx_class, shape;
    long long rdmult;
    PyObject *tabs;
    if (!PyArg_ParseTuple(args, "y*w*w*ly*lllllOLll", &tqv, &qv, &dqv,
                          &eob, &scanv, &cw, &ch, &deq_dc, &deq_ac,
                          &shift, &tabs, &rdmult, &tx_class, &shape))
        return NULL;
    RdoqRun rr;
    int ok = fill_rdoq(&rr, tabs, rdmult, tx_class, shape, 0);
    int new_eob = 0;
    if (ok) {
        int32_t dequant[2] = {(int32_t)deq_dc, (int32_t)deq_ac};
        new_eob = rdoq_optimize_txb(&rr, (const int32_t *)tqv.buf,
                                    (int32_t *)qv.buf,
                                    (int32_t *)dqv.buf, (int)eob,
                                    (const int16_t *)scanv.buf,
                                    (int)cw, (int)ch, dequant,
                                    (int)shift);
    }
    PyBuffer_Release(&tqv); PyBuffer_Release(&qv);
    PyBuffer_Release(&dqv); PyBuffer_Release(&scanv);
    if (!ok) return NULL;
    return PyLong_FromLong(new_eob);
}

static PyObject *code_block(PyObject *self, PyObject *args) {
    PyObject *cap;
    Py_buffer rv, pv, qv, ov;
    if (!PyArg_ParseTuple(args, "Oy*y*w*w*", &cap, &rv, &pv, &qv, &ov))
        return NULL;
    Plan *p = (Plan *)PyCapsule_GetPointer(cap, "block_plan");
    if (!p) {
        PyBuffer_Release(&rv); PyBuffer_Release(&pv);
        PyBuffer_Release(&qv); PyBuffer_Release(&ov);
        return NULL;
    }
    int eob = block_code_core(p, (const int32_t *)rv.buf,
                              (const int32_t *)pv.buf,
                              (int32_t *)qv.buf, (int32_t *)ov.buf);
    PyBuffer_Release(&rv); PyBuffer_Release(&pv);
    PyBuffer_Release(&qv); PyBuffer_Release(&ov);
    return PyLong_FromLong(eob);
}

static PyMethodDef methods[] = {
    {"make_plan", make_plan, METH_VARARGS, NULL},
    {"code_block", code_block, METH_VARARGS, NULL},
    {"code_block_rdoq", code_block_rdoq, METH_VARARGS, NULL},
    {"rdoq_txb", rdoq_txb, METH_VARARGS, NULL},
    {NULL, NULL, 0, NULL},
};

static PyModuleDef mod = {
    PyModuleDef_HEAD_INIT, "block_native",
    "Fused transform/quant/recon block kernel", -1, methods,
};

PyMODINIT_FUNC PyInit_block_native(void) {
    return PyModule_Create(&mod);
}
