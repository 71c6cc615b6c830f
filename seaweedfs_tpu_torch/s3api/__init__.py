"""The S3 wire protocol: the SigV4 client the remote tier uploads with.

The S3 gateway itself (`weed/s3api/`) is not ported yet. Its
SelectObjectContent execution is: the filer's ``POST /_select``
(``query/select.py``) takes the request XML the gateway forwards and
answers the framed AWS event stream.
"""
