"""NLP: Word2Vec (skip-gram and CBOW, negative sampling or hierarchical
softmax) and ParagraphVectors (PV-DBOW, PV-DM), trained on the device.

- ``text``               tokenizers, sentence iterators, LabelAwareIterator
- ``vocab``              VocabCache/VocabConstructor, Huffman, unigram table,
                         subsampling
- ``lookup_table``       InMemoryLookupTable (syn0/syn1/syn1neg, numpy
                         between fits)
- ``word2vec``           SequenceVectors engine and the Word2Vec builder front
- ``paragraph_vectors``  ParagraphVectors: PV-DBOW / PV-DM + infer_vector

The training rounds and the ``embedding_bag`` kernel that CBOW and PV-DM
launch live in ``ops/embeddings.py``. FastText, GloVe, the graph vectors
(DeepWalk, Node2Vec) and the serializer are not ported: asking for one of
them raises ``NotImplementedError``.
"""

from .lookup_table import InMemoryLookupTable
from .paragraph_vectors import ParagraphVectors
from .text import (CollectionSentenceIterator, CommonPreprocessor,
                   DefaultTokenizerFactory, LabelAwareIterator,
                   LineSentenceIterator, LowCasePreProcessor, SentenceIterator,
                   Tokenizer, TokenizerFactory, TokenPreProcess)
from .vocab import (VocabCache, VocabConstructor, VocabWord, build_huffman,
                    huffman_arrays, subsample_keep_probs, unigram_int_table,
                    unigram_table)
from .word2vec import SequenceVectors, Word2Vec, WordVectors

__all__ = [
    "CollectionSentenceIterator", "CommonPreprocessor",
    "DefaultTokenizerFactory", "InMemoryLookupTable", "LabelAwareIterator",
    "LineSentenceIterator", "LowCasePreProcessor", "ParagraphVectors",
    "SentenceIterator", "SequenceVectors", "TokenPreProcess", "Tokenizer",
    "TokenizerFactory", "VocabCache", "VocabConstructor", "VocabWord",
    "Word2Vec", "WordVectors", "build_huffman", "huffman_arrays",
    "subsample_keep_probs", "unigram_int_table", "unigram_table",
]

#: the JAX package's NLP names that the port has not ported, by module
_NOT_PORTED = {
    **dict.fromkeys(("FastText", "char_ngrams", "fasttext_hash"),
                    "FastText (nlp/fasttext.py)"),
    "Glove": "GloVe (nlp/glove.py)",
    **dict.fromkeys(("DeepWalk", "Node2Vec", "Graph", "random_walks"),
                    "the graph vectors (nlp/graph_vectors.py)"),
    **dict.fromkeys(("read_word2vec_model", "write_word2vec_model",
                     "read_word_vectors", "write_word_vectors",
                     "read_paragraph_vectors", "write_paragraph_vectors"),
                    "the serializer (nlp/serializer.py)"),
}


def __getattr__(name: str):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"{name}: {_NOT_PORTED[name]} is not ported to "
            f"deeplearning4j_tpu_torch yet (see ROADMAP.md, 'Modules to "
            f"port')")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
